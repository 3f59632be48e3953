"""mpx_torch's serving mode (``mpx_torch/serve.py``) against mpx's on the
same request lines: every op of the protocol, its error texts, stream
sessions in all three modes, the in-memory loop, the real ``python -m
mpx_torch serve`` pipe and one TCP session with a dropped client."""

import io
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from mpx.serve import Server as MpxServer
from mpx_torch.serve import Server
from tests.conftest import REPO_ROOT, random_walk
from tests.helpers import assert_profile_close


def _line(**req) -> str:
    return json.dumps(req)


def _walk(n, seed):
    return random_walk(n, seed=seed).tolist()


def _with_gap():
    T = random_walk(300, seed=8).tolist()
    T[150] = None
    return T


def _contrast_pair():
    rng = np.random.default_rng(13)
    m = 48
    Tp = rng.standard_normal(500) * 0.05
    Tm = rng.standard_normal(500) * 0.05
    pat = np.sin(np.linspace(0, 4 * np.pi, m))
    Tp[60 : 60 + m] += pat
    Tp[350 : 350 + m] += pat
    return Tp.tolist(), Tm.tolist()


def _planted(copies=4, m=32, n=900, seed=13):
    rng = np.random.default_rng(seed)
    T = rng.normal(0, 0.4, n)
    pat = np.sin(np.linspace(0, 3 * np.pi, m))
    for s in (n // (copies + 1) * (i + 1) for i in range(copies)):
        T[s : s + m] += 2.5 * pat + rng.normal(0, 0.02, m)
    return T.tolist()


_PLUS, _MINUS = _contrast_pair()
_T600 = _walk(600, 1)
_FLEET = np.cumsum(np.random.default_rng(2).standard_normal((3, 200)), axis=1).tolist()
_MULTI = np.cumsum(np.random.default_rng(88).standard_normal((3, 300)), axis=1).tolist()

# (name, request line, float64?) — one of each op, f32 and f64 where the
# op has a dtype.
REQUESTS = [
    ("ping", _line(op="ping", id=1), True),
    ("compute_f32", _line(op="compute", series=_T600, m=16, id="c"), False),
    ("compute_f64", _line(op="compute", series=_T600, m=16, dtype="float64"), True),
    ("compute_missing", _line(op="compute", series=_with_gap(), m=16, allow_missing=True,
                              dtype="float64"), True),
    ("batch", _line(op="batch", series=_FLEET, m=16), False),
    ("motifs", _line(op="motifs", series=_T600, m=16, k=2, dtype="float64"), True),
    ("discords", _line(op="discords", series=_T600, m=16, k=2, dtype="float64"), True),
    ("contrast", _line(op="contrast", plus=_PLUS, minus=_MINUS, m=48, k=2,
                       dtype="float64", band=128, chunk=128, full=True), True),
    ("chains", _line(op="chains", series=_walk(500, 4), m=32, dtype="float64"), True),
    ("chains_anchor", _line(op="chains", series=_walk(500, 4), m=32, dtype="float64",
                            anchor=100), True),
    ("thresh", _line(op="thresh", series=_walk(500, 7), m=32, threshold=0.5,
                     dtype="float64"), True),
    ("matrix", _line(op="matrix", series=_walk(400, 77), m=16, mwidth=6, mheight=6), False),
    ("matrix_ab", _line(op="matrix", series=_walk(400, 77), b=_walk(300, 78), m=16,
                        mwidth=4, mheight=5, pearson=True), False),
    ("merlin", _line(op="merlin", series=_walk(400, 77), lo=8, hi=16, k=2), True),
    ("mstamp", _line(op="mstamp", series=_MULTI, m=16, mdl=True, dtype="float64"), True),
    ("mstamp_discords", _line(op="mstamp", series=_MULTI, m=16, discords=True,
                              include=[1]), False),
    ("motiflets", _line(op="motiflets", series=_planted(), m=32, k=3, dtype="float64",
                        band=64, chunk=128), True),
    ("query", _line(op="query", series=_T600, q=_T600[50:70], k=2), True),
]

ERRORS = [
    ("not_json", "this is not json"),
    ("not_object", "[1, 2, 3]"),
    ("unknown_op", _line(op="nope", id="x")),
    ("too_short", _line(op="compute", series=[1, 2], m=64)),
    ("gap_not_allowed", _line(op="compute", series=_with_gap(), m=16)),
    ("no_stream", _line(op="stream.profile", sid="none")),
    ("drop_no_stream", _line(op="stream.drop", sid="none")),
    ("bad_mode", _line(op="stream.create", sid="q", series=_T600, m=16, mode="wat")),
    ("missing_key", _line(op="compute", m=16)),
]

# Keys whose values are window indices: equal, or (profiles) equidistant.
_INDEX_KEYS = {"mpi", "pmpi", "index", "nn_index", "a", "b", "neighbor", "chain",
               "indices", "best_k", "counts", "length", "escalated_lengths", "n"}


def _assert_same(got, want, tol, path="resp"):
    """Same structure and keys; floats within ``tol``; ints and strings
    equal (index lists are held by the caller where ties may differ)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_same(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), (path, len(got), len(want))
        a, b = np.asarray(got, dtype=object), np.asarray(want, dtype=object)
        if a.dtype == object and all(isinstance(x, (int, float)) or x is None
                                     for x in np.ravel(b)) and a.shape == b.shape:
            fa, fb = np.asarray(got, np.float64), np.asarray(want, np.float64)
            np.testing.assert_allclose(fa, fb, atol=tol, rtol=0, err_msg=path)
        else:
            for i, (g, w) in enumerate(zip(got, want)):
                _assert_same(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, bool) or isinstance(want, str) or want is None:
        assert got == want, (path, got, want)
    elif isinstance(want, int) and path.rsplit(".", 1)[-1] in _INDEX_KEYS:
        assert got == want, (path, got, want)
    else:
        assert got == pytest.approx(want, abs=tol), (path, got, want)


@pytest.fixture(scope="module")
def mpx_responses():
    s = MpxServer()
    return {name: s.handle(line) for name, line, _ in REQUESTS + [(n, l, 0) for n, l in ERRORS]}


@pytest.fixture(scope="module")
def port():
    return Server(device="cpu")


def _profile_pair(resp, want, req, tol, mp="mp", mpi="mpi"):
    """Distances within ``tol``; indices equal or equidistant."""
    T = np.asarray([np.nan if v is None else v for v in req["series"]], np.float64)
    got_mp, got_i = np.asarray(resp[mp], np.float64), np.asarray(resp[mpi])
    want_mp, want_i = np.asarray(want[mp], np.float64), np.asarray(want[mpi])
    if got_mp.ndim == 1:
        got_mp, got_i, want_mp, want_i = got_mp[None], got_i[None], want_mp[None], want_i[None]
    for r in range(got_mp.shape[0]):
        Tr = T if T.ndim == 1 else T[r]
        ok = np.isfinite(want_mp[r]) & (want_i[r] >= 0)
        assert ((got_i[r] >= 0) == (want_i[r] >= 0)).all()
        if T.ndim == 1 and not np.isfinite(Tr).all():  # gaps: compare the good windows
            assert_profile_close(np.nan_to_num(Tr), req["m"], got_mp[r][ok], got_i[r][ok],
                                 want_mp[r][ok], want_i[r][ok], eps=tol)
        else:
            np.testing.assert_allclose(got_mp[r], want_mp[r], atol=tol, rtol=0)
            assert_profile_close(Tr, req["m"], got_mp[r][ok], got_i[r][ok],
                                 want_mp[r][ok], want_i[r][ok], eps=tol)


@pytest.mark.parametrize("name,line,f64", REQUESTS, ids=[r[0] for r in REQUESTS])
def test_every_op_equals_mpxs(name, line, f64, port, mpx_responses):
    want = mpx_responses[name]
    got = port.handle(line)
    assert "error" not in want, want
    assert "error" not in got, got
    tol = 1e-8 if f64 else 2e-3
    req = json.loads(line)
    if name == "ping":
        assert got["devices"] == 1 and want["devices"] >= 1
        got, want = ({k: v for k, v in r.items() if k != "devices"} for r in (got, want))
    if "mpi" in want:  # profiles: indices equal or equidistant
        _profile_pair(got, want, req, tol)
        got, want = ({k: v for k, v in r.items() if k not in ("mp", "mpi")}
                     for r in (got, want))
    if "pmpi" in want:
        # mSTAMP rows are k-dimensional: distances within tol, indices
        # at most differing where the k-dim distances tie
        np.testing.assert_allclose(got["pmp"], want["pmp"], atol=tol, rtol=0)
        gi, wi = np.asarray(got["pmpi"]), np.asarray(want["pmpi"])
        assert (gi == wi).mean() > 0.99
        got, want = ({k: v for k, v in r.items() if k not in ("pmp", "pmpi")}
                     for r in (got, want))
    _assert_same(got, want, tol)


@pytest.mark.parametrize("name,line", ERRORS, ids=[e[0] for e in ERRORS])
def test_errors_equal_mpxs(name, line, port, mpx_responses):
    """The loop answers {"error": "<Type>: msg"} with mpx's text, echoes
    the id, and survives."""
    want = mpx_responses[name]
    got = port.handle(line)
    assert "error" in got and got == want
    assert port.handle(_line(op="ping"))["ok"] is True


def _stream_series(mode):
    if mode == "damp":
        rng = np.random.default_rng(3)
        n, m = 900, 32
        T = np.sin(2 * np.pi * np.arange(n) / 50) + rng.normal(0, 0.05, n)
        T[700 : 700 + m // 2] += rng.normal(0, 1.5, m // 2)
        return T, m
    return random_walk(900, seed=4), 16


@pytest.mark.parametrize("mode,dtype", [("full", "float64"), ("full", "float32"),
                                        ("floss", "float64"), ("damp", "float64")])
def test_stream_sessions_equal_mpxs(mode, dtype):
    """A session created, appended to several times, read and dropped:
    every response equal to mpx's on the same lines."""
    T, m = _stream_series(mode)
    tol = 1e-8 if dtype == "float64" else 2e-3
    a, b = MpxServer(), Server(device="cpu")
    create = dict(op="stream.create", sid="s", series=T[:300].tolist(), m=m, mode=mode,
                  dtype=dtype)
    if mode == "floss":
        create["window"] = 500
    lines = [_line(**create)]
    lines += [_line(op="stream.append", sid="s", points=T[o : o + 150].tolist(), id=o)
              for o in range(300, T.shape[0], 150)]
    lines += [_line(op="stream.profile", sid="s"), _line(op="ping"),
              _line(op="stream.drop", sid="s"), _line(op="stream.profile", sid="s")]
    for line in lines:
        want, got = a.handle(line), b.handle(line)
        req = json.loads(line)
        if req["op"] == "stream.profile" and "mp" in want:
            req.update(series=T.tolist(), m=m)
            if mode == "full":
                _profile_pair(got, want, req, tol)
            else:
                np.testing.assert_allclose(got["mp"], want["mp"], atol=tol, rtol=0)
            continue
        if req["op"] == "ping":
            got.pop("devices"), want.pop("devices")
        _assert_same(got, want, tol)


def test_stream_appends_refuse_gaps():
    """A gap in an append and a second create of one sid answer mpx's
    errors; the session survives both."""
    T = random_walk(300, seed=3).tolist()
    lines = [_line(op="stream.create", sid="g", series=T, m=16),
             _line(op="stream.append", sid="g", points=[1.0, None]),
             _line(op="stream.create", sid="g", series=T, m=16),
             _line(op="stream.append", sid="g", points=[1.0, 2.0])]
    a, b = MpxServer(), Server(device="cpu")
    want, got = [a.handle(ln) for ln in lines], [b.handle(ln) for ln in lines]
    assert got == want
    assert "gaps" in got[1]["error"] and "already exists" in got[2]["error"]


def test_run_loop_in_memory():
    T = random_walk(200, seed=5)
    lines = [
        _line(op="ping", id=1),
        "garbage",
        "",
        _line(op="compute", series=T.tolist(), m=16, id=2),
        _line(op="shutdown", id=3),
        _line(op="ping", id=4),  # after shutdown: unread
    ]
    outs = []
    for server in (MpxServer(), Server(device="cpu")):
        out = io.StringIO()
        assert server.run(infile=io.StringIO("\n".join(lines)), outfile=out) == 0
        outs.append([json.loads(ln) for ln in out.getvalue().splitlines()])
    want, got = outs
    assert [r.get("id") for r in got] == [r.get("id") for r in want] == [1, None, 2, 3]
    assert got[1] == want[1]
    np.testing.assert_allclose(got[2]["mp"], want[2]["mp"], atol=2e-3)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_serve_subprocess_pipe():
    """The real ``python -m mpx_torch serve --device cpu`` over a pipe."""
    T = random_walk(200, seed=6)
    reqs = "\n".join([
        _line(op="ping", id=1),
        _line(op="compute", series=T.tolist(), m=16, dtype="float64", id=2),
        _line(op="shutdown", id=3),
    ]) + "\n"
    proc = subprocess.run([sys.executable, "-m", "mpx_torch", "serve", "--device", "cpu"],
                          input=reqs, env=_env(), cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    resp = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert resp[0] == {"ok": True, "devices": 1, "streams": [], "id": 1}
    want = MpxServer().handle(reqs.splitlines()[1])
    _profile_pair(resp[1], want, {"series": T.tolist(), "m": 16}, 1e-8)
    assert resp[2] == {"ok": True, "id": 3}


def test_serve_tcp_state_persists_and_survives_a_client_drop(tmp_path):
    """TCP mode: a stream created on one connection is there on the next,
    an abruptly reset client ends only its own session, and shutdown ends
    the server."""
    s = Server(device="cpu")
    ready = str(tmp_path / "addr")
    th = threading.Thread(target=s.run_tcp,
                          kwargs={"port": 0, "ready_file": ready, "idle_timeout": 2.0},
                          daemon=True)
    th.start()
    for _ in range(200):
        if os.path.exists(ready) and open(ready).read().endswith("\n"):
            break
        time.sleep(0.05)
    host, port_ = open(ready).read().strip().split(":")
    T = random_walk(300, seed=12)
    c = socket.create_connection((host, int(port_)))
    f = c.makefile("rw", encoding="utf-8")
    f.write(_line(op="stream.create", sid="tcp1", series=T[:200].tolist(), m=16) + "\n")
    f.flush()
    assert json.loads(f.readline())["ok"]
    f.write(_line(op="ping") + "\n")
    f.flush()
    # reset the connection without reading the response
    c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    c.close()
    with socket.create_connection((host, int(port_)), timeout=30) as c2:
        f2 = c2.makefile("rw", encoding="utf-8")
        for req in ({"op": "stream.append", "sid": "tcp1", "points": T[200:].tolist()},
                    {"op": "ping"}, {"op": "shutdown"}):
            f2.write(json.dumps(req) + "\n")
            f2.flush()
            req["resp"] = json.loads(f2.readline())
        assert req["resp"]["ok"]
    th.join(timeout=30)
    assert not th.is_alive()
    assert s._streams["tcp1"].series.shape[0] == 300
