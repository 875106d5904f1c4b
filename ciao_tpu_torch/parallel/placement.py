"""Where each field of a DP or TP solver state lives on a mesh.

A torch tensor carries no sharding, so the sharded checkpoint
(:mod:`ciao_tpu_torch.checkpoint`) reads it from the tables below, stated
once per state class, as JAX's ``_SHARDED_FIELDS``/``_state_specs``
(``ciao_tpu/parallel/dp.py:257-277``) state it for its DP states. A spec
names, for each leading dimension of a field, the mesh axis it is cut
over (``"data"``: the rank's rows; ``"model"``: its columns) or None
(whole); dimensions past the spec are whole, and a field a table does
not name is whole on every rank. The tables are not guessed from
shapes: a replicated x-sized field and a cut table can have the same
local shape.

  * on a 1-D mesh (:func:`~ciao_tpu_torch.parallel.mesh.make_mesh`, the
    DP path) the tables, stepsizes and coefficients are cut by rows;
    every x-sized field and scalar is whole;
  * on a (data, model) mesh
    (:func:`~ciao_tpu_torch.parallel.mesh.make_mesh_2d`, the TP path) the
    (N,) tables and stepsizes are cut by rows (whole over "model"), the
    x-sized fields and PANOC's L-BFGS ring by columns (whole over
    "data"), and the stored points ProShI's s and SSNM's and Finito's
    ``zb`` by both.
"""

from __future__ import annotations

import torch

from ciao_tpu_torch.parallel.dp import (
    DPFBState, DPFinitoAdaptiveState, DPFinitoCoeffState, DPFinitoState,
    DPKatyushaState, DPLFinitoState, DPLKatyushaState, DPLSVRGState,
    DPPointSAGAState, DPProshiState, DPSAGAState, DPSARAHState, DPSSNMState,
    DPSVRGState,
)
from ciao_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh2D
from ciao_tpu_torch.solvers.dys import DYSState
from ciao_tpu_torch.solvers.panoc import PANOCState
from ciao_tpu_torch.solvers.primal_dual import PDState

ROWS = (DATA_AXIS,)
COLS = (MODEL_AXIS,)
BOTH = (DATA_AXIS, MODEL_AXIS)

# the DP path: the fields cut by rows over "data" (JAX's table; γ is cut
# only where it is per index, s as an (n_loc,) coefficient table or as
# (n_loc, n) rows)
DP_SPECS = {
    DPFinitoState: {"s": ROWS, "gamma": ROWS},
    DPFinitoCoeffState: {"c": ROWS, "zb": ROWS, "invg": ROWS},
    DPFinitoAdaptiveState: {"s": ROWS, "gradf": ROWS, "fi_x": ROWS,
                            "gamma": ROWS},
    DPLFinitoState: {"gamma": ROWS},
    DPSAGAState: {"s": ROWS},
    DPSVRGState: {"canch": ROWS},
    DPProshiState: {"s": ROWS, "gamma": ROWS},
    DPFBState: {},
    DPKatyushaState: {"canch": ROWS},
    DPSARAHState: {},
    DPLSVRGState: {},
    DPLKatyushaState: {},
    DPPointSAGAState: {"c": ROWS},
    DPSSNMState: {"c": ROWS, "zb": ROWS},
    DYSState: {},
    PDState: {},
    PANOCState: {},
}

# the TP path (parallel/tp.py): the same classes, their x-sized fields
# (Condat-Vũ's dual padded to (n,)) cut by columns
TP_SPECS = {
    DPSAGAState: {"s": ROWS, "av": COLS, "z": COLS},
    DPFinitoCoeffState: {"c": ROWS, "zb": BOTH, "invg": ROWS, "av": COLS,
                         "z": COLS},
    DPLFinitoState: {"gamma": ROWS, "av": COLS, "z": COLS, "z_full": COLS},
    DPSVRGState: {"av": COLS, "z": COLS, "z_full": COLS, "w": COLS},
    DPProshiState: {"s": BOTH, "gamma": ROWS, "av": COLS, "z": COLS},
    DPFBState: {"x": COLS, "y": COLS},
    DPKatyushaState: {"av": COLS, "x_tilde": COLS, "y": COLS, "z": COLS},
    DPSARAHState: {"x_tilde": COLS},
    DPLSVRGState: {"av": COLS, "z": COLS, "w": COLS},
    DPLKatyushaState: {"av": COLS, "w_anchor": COLS, "y": COLS, "z": COLS},
    DPPointSAGAState: {"c": ROWS, "av": COLS, "x": COLS},
    DPSSNMState: {"c": ROWS, "zb": BOTH, "gbar": COLS, "x": COLS},
    DYSState: {"z": COLS, "xg": COLS},
    PDState: {"x": COLS, "y": COLS},
    PANOCState: {"x": COLS, "gradx": COLS, "z": COLS, "S": (None,) + COLS,
                 "Y": (None,) + COLS, "pbase": COLS, "presid": COLS},
}

# the fields that hold one row a block of B rows: they move to another
# mesh only where N/D is a multiple of the same B on both
BLOCK_FIELDS = {DPFinitoCoeffState: ("zb", "invg"), DPSSNMState: ("zb",)}


def state_specs(state, mesh) -> dict:
    """Each tensor field of ``state`` (by name) with its spec on ``mesh``,
    one axis name or None a dimension: the DP table on a 1-D mesh, the TP
    table on a (data, model) mesh; every field whole with no mesh. A
    state class neither table names raises ``ValueError``."""
    cls = type(state)
    if mesh is None:
        table = {}
    else:
        table = (TP_SPECS if isinstance(mesh, Mesh2D) else DP_SPECS).get(
            cls)
        if table is None:
            kind = "(data, model)" if isinstance(mesh, Mesh2D) else "1-D"
            raise ValueError(f"no placement of {cls.__name__} on a {kind} "
                             f"mesh: the sharded checkpoint takes the DP "
                             f"and TP solvers' states")
    out = {}
    for name in cls._fields:
        v = getattr(state, name)
        if isinstance(v, torch.Tensor):
            spec = tuple(table.get(name, ()))
            if len(spec) > v.dim():
                raise ValueError(f"{cls.__name__}.{name}: a {v.dim()}-d "
                                 f"field cannot take the spec {spec}")
            out[name] = spec + (None,) * (v.dim() - len(spec))
    return out
