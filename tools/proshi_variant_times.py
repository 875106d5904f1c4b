#!/usr/bin/env python3
"""Times kernel #18 (``proshi_multistep``) built from a copy of the port's
``csrc/`` on one NVIDIA GPU, so that variants of the persistent engine
(``loopless_steps.cuh``) can be compared in one call.

    python3 tools/proshi_variant_times.py DIR          # time DIR's build
    python3 tools/proshi_variant_times.py DIR build    # build it only

DIR holds a variant ``csrc/``; the library is built into ``DIR/_build``
with this checkout's ``ops/_build.py`` (start the builds of several
variants together, then time them in turns: A, B, ..., B, A). The
timing is ``tools/loopless_step_times.py``'s #18 entry with ``--profile``
(the ProShI configuration: 65,536 x 1,024 Gaussian rows, B = 4,096,
calls of K = 128 cyclic steps, f32, bf16 and int8), on this checkout's
wrappers. Prints one JSON line, tagged with DIR's name and the card's name
and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ciao_tpu_torch.ops import _build

    vdir = Path(sys.argv[1]).resolve()
    _build.CSRC = vdir / "csrc"
    _build.BUILD_DIR = vdir / "_build"
    if len(sys.argv) == 3:
        _build.build("proshi_multistep")
        return 0
    if not torch.cuda.is_available():
        print("proshi_variant_times: no CUDA device", file=sys.stderr)
        return 2
    cs = _module("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    lst = _module("loopless_step_times",
                  os.path.join(ROOT, "tools", "loopless_step_times.py"))
    from ciao_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ceil = cs.read_ceiling(dev)
    A = torch.randn(lst.PROSHI_N, lst.n, generator=gen, device=dev)
    b = torch.randn(lst.PROSHI_N, generator=gen, device=dev)
    lst.PROFILE = True
    out = {"tag": vdir.name, "card": cs.card_info(), "steps": []}
    lst.time_proshi(out, cs, fb, A, b, gen, dev, ceil)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
