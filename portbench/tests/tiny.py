"""The tests' own entry: a cell rehearsed on the CPU at tiny sizes,
through the harness's whole run (``harness.run_cell``) with the program's
plain PyTorch paths.  The measurement command itself needs a card."""

from __future__ import annotations

from portbench import files, harness

WALK = {"m": 16, "data": {"kind": "random_walk", "length": 1024}}

TINY = {
    "showcase-f64.selfjoin": {"config": WALK,
                              "traffic": {"warmup_length": 256,
                                          "check": {"share": 1.0, "rows": "all"}}},
    "showcase-f64.append": {"config": WALK,
                            "traffic": {"warmup_appends": 4,
                                        "check": {"improved": 64, "old": 64}}},
}


def rehearse(workload: str, *, seed: int = 2**31 + 77, seconds: float = 0.3,
             trace: bool = False, root: str = files.ROOT, overrides: dict | None = None,
             device: str = "cpu") -> dict:
    ov = overrides if overrides is not None else TINY[workload]
    return harness.run_cell(root, workload, seed, seconds, trace, device=device, overrides=ov)
