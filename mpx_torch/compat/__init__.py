"""Drop-in API shims for ecosystems reference users come from,
counterpart of ``mpx/compat``.

* :mod:`mpx_torch.compat.pyscamp` — the pyscamp module surface (the
  reference's own golden tooling imports ``pyscamp`` —
  util/matrix_profile.py:2).
* :mod:`mpx_torch.compat.stumpy` — the STUMPY function surface.

Every function takes ``device=`` ("cuda" by default; "cpu" off the card).
"""
