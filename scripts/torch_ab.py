"""Parent-against-change readings of the port's phases on one card:
phases 2 (K1 against its plain version at band level, f32 and f64), 4
(f32 n=2^20 through K1), 7 (the f64 showcase through K3), 10 (the same
through K1), 12 (through the hybrid, with its pass-B profile) and 14 (its
left/right profiles) of a source tree's ``chip_smoke.py``, run in that tree
with its kernels built anew.

    python3 scripts/torch_ab.py TREE LABEL

Unpack the parent commit into a git-ignored directory
(``git archive <parent> | tar -x -C tmp_chip/parent``) and run the two
trees in turns within one call on the card, e.g. parent, change, change,
parent, parent, change; each run prints its phase lines after a
``=== LABEL`` line.
"""

import os
import shutil
import sys

tree, label = os.path.abspath(sys.argv[1]), sys.argv[2]
shutil.rmtree(os.path.join(tree, "mpx_torch", "_build"), ignore_errors=True)
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if not cs.__file__.startswith(tree):
    raise SystemExit(f"chip_smoke.py imported from {cs.__file__}, not from {tree}")
print(f"=== {label} {tree}", flush=True)
cs.phase_build()
for dt in ("float32", "float64"):
    cs.phase_band(torch, dt)
cs.phase_e2e_f32(torch)
_, k3p, k3w = cs.phase_showcase(torch, f"7 showcase f64 K3 [{label}]", "pallas", "k3",
                                cs.SEED + 2)
_, _, k1w = cs.phase_showcase(torch, f"10 showcase f64 auto (K1) [{label}]", "auto", "k1",
                              cs.SEED + 4)
cs.phase_left_right_hybrid(torch, cs.phase_showcase_hybrid(torch, k3p, k3w, k1w))
