"""Serving mode: a persistent NDJSON request loop, counterpart of
``mpx/serve.py``.

The reference is a one-shot batch binary (host/MatrixProfileHost.cpp:
54-160: load -> one kernel sequence -> store -> exit); a long-lived
process is the opposite shape: it builds (or loads) the kernel library
once and then answers many requests with warm kernels and a warm
allocator.  ``python -m mpx_torch serve`` reads one JSON request per line
on stdin and writes one JSON response per line on stdout, so it composes
with anything (a socket via socat/inetd, a subprocess pipe, a container
entrypoint).  State that benefits from residency (the loaded kernel
library, the caching allocator's blocks, streaming/FLOSS/DAMP sessions
whose state lives on the card) lives for the process lifetime.

Protocol (one object per line; every response carries "id" if the
request had one, and either the result or {"error": msg}):

  {"op":"ping"}                          -> {"ok":true,"devices":N,"streams":[..]}
       (N: torch.cuda.device_count() on a card, 1 on the CPU; mpx
        reports len(jax.devices()))
  {"op":"compute","series":[...],"m":64,
   "dtype"?,"kernel"?,"allow_missing"?}  -> {"mp":[...],"mpi":[...]}
       (allow_missing: null/NaN series elements become gaps with
        masked-join semantics — see mpx_torch/missing.py)
  {"op":"batch","series":[[...],...],"m":64}
                                         -> {"mp":[[..]],"mpi":[[..]]}
  {"op":"motifs","series":[...],"m":64,"k"?}   -> {"motifs":[...]}
  {"op":"discords","series":[...],"m":64,"k"?} -> {"discords":[...]}
  {"op":"contrast","plus":[...],"minus":[...],"m":64,"k"?,"full"?}
                                         -> {"motifs":[...],"cp"?}
  {"op":"chains","series":[...],"m":64,"anchor"?}
                                         -> {"chain":[...],"length":L}
  {"op":"thresh","series":[...],"m":64,"threshold"?}
                                         -> {"sums":[...],"counts":[...]}
  {"op":"matrix","series":[...],"m":64,"b"?,"mwidth"?,"mheight"?,
   "pearson"?}                           -> {"matrix":[[...],...]}
  {"op":"merlin","series":[...],"lo":8,"hi":64,"k"?}
                                         -> {"top":[...],"per_length":[...]}
  {"op":"mstamp","series":[[...],...],"m":64,"include"?,"discords"?,
   "mdl"?}                               -> {"pmp":[[..]],"pmpi":[[..]],
                                             "best_k"?,"bitsaves"?}
  {"op":"motiflets","series":[...],"m":64,"k":5,"candidates"?}
                                         -> {"indices":[...],"extent":E}
  {"op":"query","series":[...],"q":[...],"k"?} -> {"matches":[...]}
  {"op":"stream.create","sid":"a1","series":[...],"m":64,
   "mode":"damp","threshold"?}            -> online anomaly session:
     stream.append returns {"alerts":[{index,distance}...],"discord"?}
  {"op":"stream.create","sid":"s1","series":[...],"m":64,
   "mode":"full"|"floss","window"?}      -> {"ok":true}
  {"op":"stream.append","sid":"s1","points":[...]}
       full  -> {"n":N}
       floss -> {"n":N,"score":c,"regimes":[...]}
  {"op":"stream.profile","sid":"s1"}     -> {"mp":[...],"mpi":[...]}
  {"op":"stream.drop","sid":"s1"}        -> {"ok":true}
  {"op":"shutdown"}                      -> {"ok":true} (then exits)

Every request runs on the server's device (``Server(device=...)``,
``serve --device``).  Malformed lines and failed requests answer
{"error": "<Type>: msg"} and the loop continues — a serving process must
not die on one bad request.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from mpx_torch.analysis import _host
from mpx_torch.config import MatrixProfileConfig


def _series(x) -> np.ndarray:
    """JSON list -> float64 array; null elements become NaN (the JSON
    spelling of a gap — Python's json also accepts the NaN literal)."""
    return np.asarray([np.nan if v is None else v for v in x], np.float64)


def _cfg(req: dict, device) -> MatrixProfileConfig:
    kw = {"m": int(req["m"]), "device": device}
    for key in ("dtype", "kernel", "band", "chunk"):
        if key in req:
            kw[key] = req[key]
    return MatrixProfileConfig(**kw)


def _f64(x) -> list:
    return np.asarray(_host(x), np.float64).tolist()


def _i64(x) -> list:
    return np.asarray(_host(x), np.int64).tolist()


class Server:
    """Request dispatcher; one instance per process holds all warm state.
    ``device`` is where every request and stream session runs."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self._streams: Dict[str, object] = {}
        self._shutdown = False

    # -- one-shot ops ------------------------------------------------------

    def _op_ping(self, req):
        dev = torch.device(self.device)
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        return {"ok": True, "devices": n, "streams": sorted(self._streams)}

    def _op_compute(self, req):
        if req.get("allow_missing"):
            from mpx_torch.missing import compute_matrix_profile_masked as fn
        else:
            from mpx_torch.driver import compute_matrix_profile as fn

        T = _series(req["series"])
        MP, MPI = fn(T, config=_cfg(req, self.device))
        return {"mp": _f64(MP), "mpi": _i64(MPI)}

    def _op_batch(self, req):
        from mpx_torch.batch import compute_batch_profiles

        B = np.asarray(req["series"], np.float64)
        MP, MPI = compute_batch_profiles(B, config=_cfg(req, self.device))
        return {"mp": _f64(MP), "mpi": _i64(MPI)}

    def _op_motifs(self, req):
        from mpx_torch.analysis import top_motifs
        from mpx_torch.driver import compute_matrix_profile

        T = np.asarray(req["series"], np.float64)
        m = int(req["m"])
        MP, MPI = compute_matrix_profile(T, config=_cfg(req, self.device))
        mos = top_motifs(MP, MPI, m, k=int(req.get("k", 3)))
        return {"motifs": [{"a": mo.a, "b": mo.b,
                            "distance": mo.distance} for mo in mos]}

    def _op_discords(self, req):
        from mpx_torch.analysis import top_discords
        from mpx_torch.driver import compute_matrix_profile

        T = np.asarray(req["series"], np.float64)
        m = int(req["m"])
        MP, MPI = compute_matrix_profile(T, config=_cfg(req, self.device))
        dis = top_discords(MP, MPI, m, k=int(req.get("k", 3)))
        return {"discords": [{"index": d.index,
                              "distance": d.distance} for d in dis]}

    def _op_contrast(self, req):
        from mpx_torch.contrast import contrast_profile, top_contrast_motifs

        Tp = _series(req["plus"])
        Tm = _series(req["minus"])
        m = int(req["m"])
        res = contrast_profile(Tp, Tm, config=_cfg(req, self.device))
        mots = top_contrast_motifs(res, m, k=int(req.get("k", 3)))
        out = {"motifs": [{"index": mo.index, "neighbor": mo.neighbor,
                           "score": mo.score} for mo in mots]}
        if req.get("full"):
            out["cp"] = _f64(res.cp)
        return out

    def _op_motiflets(self, req):
        from mpx_torch.motiflets import k_motiflets

        T = _series(req["series"])
        res = k_motiflets(T, k=int(req["k"]), config=_cfg(req, self.device),
                          candidates=int(req.get("candidates", 64)))
        return {"indices": _i64(res.indices),
                "extent": float(res.extent)}

    def _op_thresh(self, req):
        from mpx_torch.thresh import compute_sum_thresh

        T = _series(req["series"])
        sums, cnts = compute_sum_thresh(
            T, config=_cfg(req, self.device),
            threshold=float(req.get("threshold", 0.0)))
        return {"sums": _f64(sums), "counts": _i64(cnts)}

    def _op_mstamp(self, req):
        from mpx_torch.mstamp import compute_multidim_profile, multidim_mdl

        T = np.stack([_series(s) for s in req["series"]])
        if T.ndim != 2:
            raise ValueError("mstamp needs a list of equal-length series")
        prof = compute_multidim_profile(
            T, config=_cfg(req, self.device), include=req.get("include"),
            discords=bool(req.get("discords", False)))
        out = {"pmp": _f64(prof.PMP), "pmpi": _i64(prof.PMPI)}
        if req.get("mdl") and not req.get("discords"):
            res = multidim_mdl(T, int(req["m"]), profile=prof,
                               include=req.get("include"))
            out["best_k"] = res.best_k
            out["bitsaves"] = _f64(res.bitsaves)
        return out

    def _op_matrix(self, req):
        from mpx_torch.distmatrix import pooled_matrix

        T = _series(req["series"])
        B = _series(req["b"]) if req.get("b") is not None else None
        M = pooled_matrix(
            T, config=_cfg(req, self.device), B=B,
            mwidth=int(req.get("mwidth", 50)),
            mheight=int(req.get("mheight", 50)),
            pearson=bool(req.get("pearson", False)))
        return {"matrix": _f64(M)}

    def _op_merlin(self, req):
        from mpx_torch.merlin import multi_length_discords

        T = _series(req["series"])
        lo, hi = int(req["lo"]), int(req["hi"])
        # the pan survey reads its device from a config and ignores its m
        res = multi_length_discords(
            T, lo, hi, k=int(req.get("k", 3)),
            config=MatrixProfileConfig(m=lo, device=self.device))
        as_dict = lambda d: {"m": d.m, "index": d.index,
                             "nn_index": d.nn_index,
                             "distance": d.distance, "score": d.score}
        return {"top": [as_dict(d) for d in res.top],
                "per_length": [as_dict(d) for d in res.per_length],
                "exact": res.exact,
                "escalated_lengths": list(res.escalated_lengths)}

    def _op_chains(self, req):
        from mpx_torch.chains import compute_chains

        T = _series(req["series"])
        anchor = req.get("anchor")
        res = compute_chains(T, config=_cfg(req, self.device),
                             anchor=None if anchor is None else int(anchor))
        return {"chain": _i64(res.chain),
                "length": res.length}

    def _op_query(self, req):
        from mpx_torch.analysis import match

        hits = match(np.asarray(req["q"], np.float64),
                     np.asarray(req["series"], np.float64),
                     max_matches=int(req.get("k", 3)),
                     max_distance=req.get("max_distance"))
        return {"matches": [{"index": h.index,
                             "distance": h.distance} for h in hits]}

    # -- streaming sessions --------------------------------------------------

    def _op_stream_create(self, req):
        sid = str(req["sid"])
        if sid in self._streams:
            raise ValueError(f"stream {sid!r} already exists")
        mode = req.get("mode", "full")
        T = np.asarray(req["series"], np.float64)
        m = int(req["m"])
        dtype = req.get("dtype", "float32")
        if mode == "floss":
            from mpx_torch.floss import Floss

            self._streams[sid] = Floss(T, m=m, window=req.get("window"),
                                       dtype=dtype, device=self.device)
        elif mode == "damp":
            from mpx_torch.damp import OnlineAnomalyDetector

            thr = req.get("threshold")
            self._streams[sid] = OnlineAnomalyDetector(
                T, config=MatrixProfileConfig(m=m, dtype=dtype, device=self.device),
                threshold=None if thr is None else float(thr))
        elif mode == "full":
            from mpx_torch.streaming import StreamingMatrixProfile

            self._streams[sid] = StreamingMatrixProfile(T, m=m, dtype=dtype,
                                                        device=self.device)
        else:
            raise ValueError(f"unknown stream mode {mode!r}")
        return {"ok": True}

    def _stream(self, req):
        sid = str(req["sid"])
        if sid not in self._streams:
            raise KeyError(f"no stream {sid!r}")
        return self._streams[sid]

    def _op_stream_append(self, req):
        from mpx_torch.damp import OnlineAnomalyDetector
        from mpx_torch.floss import Floss

        s = self._stream(req)
        points = _series(req["points"])
        if not np.isfinite(points).all():
            raise ValueError(
                "streaming appends cannot carry gaps (no masked "
                "semantics for incremental state); fill them first"
            )
        if isinstance(s, OnlineAnomalyDetector):
            alerts = s.append(points)
            out = {"n": int(s.series.shape[0]),
                   "alerts": [{"index": a.index, "distance": a.distance}
                              for a in alerts]}
            if s.discord is not None:
                out["discord"] = {"index": s.discord.index,
                                  "distance": s.discord.distance}
            return out
        s.append(points)
        out = {"n": int(s.series.shape[0])}
        if isinstance(s, Floss):
            from mpx_torch.analysis import extract_regimes

            # one CAC evaluation feeds both fields (score/regimes each
            # refetch the device profile if called separately)
            cac = s.cac()
            out["score"] = float(cac.min())
            out["regimes"] = [
                int(s.offset + r)
                for r in extract_regimes(cac, s.m, k=int(req.get("k", 1)))
            ]
        return out

    def _op_stream_profile(self, req):
        MP, MPI = self._stream(req).profile()
        return {"mp": _f64(MP), "mpi": _i64(MPI)}

    def _op_stream_drop(self, req):
        sid = str(req["sid"])
        if self._streams.pop(sid, None) is None:
            raise KeyError(f"no stream {sid!r}")
        return {"ok": True}

    def _op_shutdown(self, req):
        self._shutdown = True
        return {"ok": True}

    # -- loop ----------------------------------------------------------------

    _OPS = {
        "ping": _op_ping,
        "compute": _op_compute,
        "batch": _op_batch,
        "motifs": _op_motifs,
        "discords": _op_discords,
        "contrast": _op_contrast,
        "chains": _op_chains,
        "matrix": _op_matrix,
        "merlin": _op_merlin,
        "mstamp": _op_mstamp,
        "motiflets": _op_motiflets,
        "thresh": _op_thresh,
        "query": _op_query,
        "stream.create": _op_stream_create,
        "stream.append": _op_stream_append,
        "stream.profile": _op_stream_profile,
        "stream.drop": _op_stream_drop,
        "shutdown": _op_shutdown,
    }

    def handle(self, line: str) -> Optional[dict]:
        """One request line -> one response dict (never raises)."""
        rid = None
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
            rid = req.get("id")
            op = self._OPS.get(req.get("op"))
            if op is None:
                raise ValueError(f"unknown op {req.get('op')!r}")
            resp = op(self, req)
        except Exception as e:  # noqa: BLE001 - the loop must survive
            resp = {"error": f"{type(e).__name__}: {e}"}
        if rid is not None:
            resp["id"] = rid
        return resp

    def _session(self, infile, outfile) -> None:
        """One NDJSON session: the shared protocol loop for both
        transports (skip blanks, handle, respond, stop on shutdown)."""
        for line in infile:
            if not line.strip():
                continue
            resp = self.handle(line)
            outfile.write(json.dumps(resp) + "\n")
            outfile.flush()
            if self._shutdown:
                break

    def run(self, infile=None, outfile=None) -> int:
        """Blocking NDJSON loop until EOF or a shutdown request."""
        from mpx_torch.runtime import enable_compilation_cache

        enable_compilation_cache()
        self._session(infile if infile is not None else sys.stdin,
                      outfile if outfile is not None else sys.stdout)
        return 0

    def run_tcp(self, host: str = "127.0.0.1", port: int = 0,
                once: bool = False, ready_file=None,
                idle_timeout: float = 300.0) -> int:
        """TCP server: each connection is an NDJSON session against the
        SAME warm state (the kernel library, the allocator and the streams
        persist across connections).  Single-threaded accept loop —
        requests serialize through the one device anyway, so concurrency
        would only reorder them.  A shutdown request ends the whole server
        (connection close just ends that session).  ``port=0`` picks a
        free port; the bound address is printed (and written to
        ``ready_file`` if given) before accepting.

        ``idle_timeout`` (seconds) bounds how long one connection may
        sit silent: an abruptly-dropped client (RST after the server's
        last write consumes the socket error) otherwise blocks the
        single-threaded loop forever.  Idle-dropped clients simply
        reconnect — their streams and the warm state persist.

        Head-of-line caveat: because the accept loop is single-threaded,
        one connected-but-silent client stalls every OTHER client for up
        to ``idle_timeout``.  The TCP mode is effectively single-client;
        for multiple interactive clients, lower ``--idle-timeout`` (a
        few seconds) so an idle holder yields the socket quickly, and
        have clients treat a drop as "reconnect and retry"."""
        import socket

        from mpx_torch.runtime import enable_compilation_cache

        enable_compilation_cache()
        srv = socket.create_server((host, port))
        bound = srv.getsockname()
        msg = f"mpx_torch serve listening on {bound[0]}:{bound[1]}"
        print(msg, flush=True)
        if ready_file:
            with open(ready_file, "w") as f:
                f.write(f"{bound[0]}:{bound[1]}\n")
        try:
            while not self._shutdown:
                conn, addr = srv.accept()
                try:
                    conn.settimeout(idle_timeout)
                    with conn, conn.makefile("rw", encoding="utf-8") as f:
                        self._session(f, f)
                except (OSError, ValueError) as e:
                    # an abruptly-dropped client (reset, broken pipe)
                    # ends ITS session only — the server and every warm
                    # stream must survive
                    print(f"client {addr} dropped: {e}", file=sys.stderr)
                if once:
                    break
        finally:
            srv.close()
        return 0
