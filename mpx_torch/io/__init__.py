from mpx_torch.io.tsb import read_binary, read_series, write_binary, write_results

__all__ = ["read_binary", "read_series", "write_binary", "write_results"]
