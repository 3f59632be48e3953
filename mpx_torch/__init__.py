"""mpx_torch: the matrix-profile framework in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``mpx`` (which stays the reference); module names
match mpx's.  This package imports ``torch`` and never ``jax`` or ``mpx``.
Ported so far: the single-series self-join (``matrix_profile``,
``compute_matrix_profile``, ``left_right=True`` for the left/right
profiles) through the fused tile-sweep kernel K1 (``kernels/mxu_fused.py``,
``csrc/mxu_fused.cu``), the SCAMP recurrence K3 (``kernels/recurrence.py``,
``csrc/band_recurrence.cu``) and the hybrid float64 tier (``hybrid.py``,
``kernel='hybrid'``); the fixed-point input tier (``io/apfixed.py``,
``dtype='ap16'`` .. ``'ap64'``); ``io/`` and ``bench.py``; the AB-join
(``abjoin.py``, K1 with a second operand, and its hybrid), the top-k
profiles (``topk.py``, float64 also through the hybrid), the
sum-threshold profiles (``thresh.py``), the raw-Euclidean profiles
(``aamp.py``) and the pooled distance-matrix summary (``distmatrix.py``);
the multi-dimensional profile (``mstamp.py``), the pan profile across
window lengths (``pan.py``, its fused sweep ``pan_kernel.py``) and exact
multi-length discords and motifs (``merlin.py``); the schedule
variants: streaming appends (``streaming.py``) with FLOSS (``floss.py``,
``analysis.py``) and online DAMP (``damp.py``, with batch DAMP), the
anytime profile (``anytime.py``), resumable checkpoints (``checkpoint.py``,
the strict tiers and the hybrid), the fleet batch (``batch.py``) and
masked gaps (``missing.py``); the compositions: motifs, discords,
guided search, MPdist and MASS (``analysis.py``), chains (``chains.py``),
the contrast profile (``contrast.py``), consensus motifs
(``ostinato.py``), snippets (``snippets.py``), MPdist clustering
(``cluster.py``) and k-motiflets (``motiflets.py``); and the ``compute`` (``--raw``,
``--checkpoint``, ``--approx``, ``--allow-missing``), ``abjoin``,
``topk``, ``thresh``, ``matrix``, ``mstamp``, ``pan``, ``merlin``,
``damp``, ``batch``, ``floss``, ``analyze``, ``chains``, ``contrast``,
``ostinato``, ``snippets``, ``cluster``, ``motiflets``, ``query``,
``tsbin``, ``golden``, ``datasets`` and ``bench`` command lines
(``python -m mpx_torch ...``).
"""

from mpx_torch.aamp import compute_aamp_ab_join, compute_aamp_profile
from mpx_torch.abjoin import compute_ab_join
from mpx_torch.analysis import (
    all_chains,
    apply_annotation_vector,
    complexity_annotation,
    corrected_arc_curve,
    extract_regimes,
    mass,
    match,
    mpdist,
    one_directional_cac,
    regimes,
    top_discords,
    top_motifs,
    unanchored_chain,
)
from mpx_torch.anytime import anytime_matrix_profile, approx_matrix_profile
from mpx_torch.batch import compute_batch_profiles
from mpx_torch.chains import ChainsResult, anchored_chain, chain_lengths, compute_chains
from mpx_torch.cluster import cluster_series, hierarchical_cluster, mpdist_matrix
from mpx_torch.config import MatrixProfileConfig, make_job_grid
from mpx_torch.contrast import (
    best_contrast,
    contrast_profile,
    pan_contrast_profile,
    top_contrast_motifs,
)
from mpx_torch.damp import Anomaly, OnlineAnomalyDetector, compute_damp
from mpx_torch.distmatrix import pooled_matrix
from mpx_torch.driver import compute_matrix_profile, matrix_profile
from mpx_torch.dtypes import AGGREGATE_INIT, INDEX_INIT
from mpx_torch.floss import Floss
from mpx_torch.merlin import (
    LengthDiscord,
    MerlinResult,
    multi_length_discords,
    multi_length_motifs,
)
from mpx_torch.missing import compute_matrix_profile_masked, missing_window_mask
from mpx_torch.motiflets import Motiflet, k_motiflets, motiflet_elbows
from mpx_torch.mstamp import (
    MdlResult,
    compute_multidim_profile,
    multidim_discord,
    multidim_mdl,
    multidim_motif,
    multidim_subspace,
)
from mpx_torch.ostinato import ostinato
from mpx_torch.pan import compute_pan_profile, pan_discords, pan_m_range, pan_motifs
from mpx_torch.snippets import snippets
from mpx_torch.thresh import compute_sum_thresh, compute_sum_thresh_ab
from mpx_torch.topk import compute_topk_profile
from mpx_torch.types import Aggregates, JobGrid, Stats

__version__ = "0.1.0"

__all__ = [
    "MatrixProfileConfig",
    "make_job_grid",
    "compute_matrix_profile",
    "matrix_profile",
    "compute_ab_join",
    "compute_topk_profile",
    "compute_sum_thresh",
    "compute_sum_thresh_ab",
    "compute_aamp_profile",
    "compute_aamp_ab_join",
    "pooled_matrix",
    "compute_multidim_profile",
    "multidim_motif",
    "multidim_discord",
    "multidim_subspace",
    "multidim_mdl",
    "MdlResult",
    "compute_pan_profile",
    "pan_m_range",
    "pan_motifs",
    "pan_discords",
    "multi_length_discords",
    "multi_length_motifs",
    "LengthDiscord",
    "MerlinResult",
    "anytime_matrix_profile",
    "approx_matrix_profile",
    "corrected_arc_curve",
    "extract_regimes",
    "one_directional_cac",
    "regimes",
    "Anomaly",
    "OnlineAnomalyDetector",
    "compute_damp",
    "Floss",
    "compute_batch_profiles",
    "compute_matrix_profile_masked",
    "missing_window_mask",
    "top_motifs",
    "top_discords",
    "apply_annotation_vector",
    "complexity_annotation",
    "all_chains",
    "unanchored_chain",
    "mpdist",
    "mass",
    "match",
    "ChainsResult",
    "anchored_chain",
    "chain_lengths",
    "compute_chains",
    "contrast_profile",
    "top_contrast_motifs",
    "pan_contrast_profile",
    "best_contrast",
    "ostinato",
    "snippets",
    "mpdist_matrix",
    "hierarchical_cluster",
    "cluster_series",
    "Motiflet",
    "k_motiflets",
    "motiflet_elbows",
    "Aggregates",
    "JobGrid",
    "Stats",
    "AGGREGATE_INIT",
    "INDEX_INIT",
    "__version__",
]
