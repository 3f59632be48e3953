from mpx_torch.io.tsb import (
    read_ascii,
    read_binary,
    read_series,
    write_ascii,
    write_binary,
    write_results,
)
from mpx_torch.io.datasets import dataset_path, list_datasets, load_dataset

__all__ = [
    "read_ascii",
    "read_binary",
    "read_series",
    "write_ascii",
    "write_binary",
    "write_results",
    "dataset_path",
    "list_datasets",
    "load_dataset",
]
