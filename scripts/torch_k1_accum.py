"""K1's float32 accumulation, parent against change, on one card: a source
tree's kernels built anew (with ptxas's registers and spills), phase 2's
f32 band-level times (K1 against its plain version, S=4096, W=16384,
m=256) and the accuracy sweep of ``chip_smoke.phase_k1_accuracy`` (one
K1 f32 job of 4096 x 16384 at m = 256 .. 4096 against the exact f64 row
scan, the plain sweep beside), with ``mpx_torch`` imported from TREE and
the phases from this checkout's ``chip_smoke.py``.

    python3 scripts/torch_k1_accum.py TREE LABEL

Unpack the parent commit into a git-ignored directory
(``git archive <parent> | tar -x -C tmp_chip/parent``) and run the two
trees in turns within one call on the card (parent, change, change,
parent); each run prints its lines after a ``=== LABEL`` line.
"""

import importlib.util
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
tree, label = os.path.abspath(sys.argv[1]), sys.argv[2]
shutil.rmtree(os.path.join(tree, "mpx_torch", "_build"), ignore_errors=True)
sys.path.insert(0, tree)
import torch  # noqa: E402

import mpx_torch  # noqa: E402

if not mpx_torch.__file__.startswith(tree):
    raise SystemExit(f"mpx_torch imported from {mpx_torch.__file__}, not from {tree}")
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
print(f"=== {label} {tree}", flush=True)
cs.phase_build()
cs.phase_band(torch, "float32")
print(f"[k1 accuracy {label}] " + json.dumps(cs.phase_k1_accuracy(torch)), flush=True)
