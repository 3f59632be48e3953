"""The port's benchmark: ``python -m portbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, from the root of a checkout on a machine
with the cell's CUDA devices.  ``BENCHMARK.json`` names the cells; the
files under this folder hold the rest, one file per configuration,
traffic mix, request loop, metric and reference (``files.py``)."""
