"""The port's dp×tp layer (fermi_tpu_torch/dist/sharded.py) against
fermi_tpu, with real ranks: processes over gloo on the CPU.

For each mesh shape (dp, tp) in {(2, 1), (1, 2), (2, 2)} one module-scoped
spawn starts dp·tp workers (file:// rendezvous under tmp_path, so no ports
race between test workers); they import only torch and fermi_tpu_torch,
run every sharded function on the same inputs and write their results to
files.  This process computes the oracle with fermi_tpu on the CPU: its
single-device FMDIndex, smem_all, fm_merge, merge_bwts and multistring_bwt,
and its own ShardedSMEM on the same dp×tp shape of the virtual 8-device
mesh of conftest.py.  Every output is an integer or a byte: equality.
"""

import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fermi_tpu.algos.merge import compute_gap_bits, fm_merge, merge_bwts
from fermi_tpu.construct import suffix
from fermi_tpu.core import dna
from fermi_tpu.dist import sharded as jsh
from fermi_tpu.index.fmd import FMDIndex as JIndex
from fermi_tpu.search.smem import smem_all

from util import random_reads

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 1), (1, 2), (2, 2)]
SPAWN_TIMEOUT_S = 300

_WORKER = r"""
import os, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, init, inp, out, dp, tp = sys.argv[1:8]
rank, world, dp, tp = int(rank), int(world), int(dp), int(tp)

from fermi_tpu_torch.dist import sharded as sh
from fermi_tpu_torch.index import fmd
from fermi_tpu_torch.search import smem as sm

sh.init_ranks(rank, world, init, "cpu", timeout_s=120)
D = dict(np.load(inp))
split = lambda a, off: [a[off[i]:off[i + 1]] for i in range(len(off) - 1)]
res = {}

res["mesh_default"] = sh.make_mesh(device="cpu").shape
res["mesh_dp"] = sh.make_mesh(dp=dp, device="cpu").shape
res["mesh_tp"] = sh.make_mesh(tp=tp, device="cpu").shape
try:
    sh.make_mesh(dp=world, tp=2, device="cpu")
except ValueError as e:
    res["oversize"] = str(e)
mesh = sh.make_mesh(dp=dp, tp=tp, device="cpu")
res["place"] = (mesh.dp_rank, mesh.tp_rank, mesh.backend)

def index(kind):
    pick = fmd._pick_idtype
    if kind == "int64":
        fmd._pick_idtype = lambda n: torch.int64
    try:
        idx = fmd.FMDIndex.from_bwt(D["bwt"], "cpu")
    finally:
        fmd._pick_idtype = pick
    if kind == "unfused":
        idx.fused = None
    return idx

for kind in ("int32", "int64", "unfused"):
    idx = index(kind)
    v = sh.TpIndexView(idx, mesh)
    k = torch.arange(idx.total + 1, dtype=idx.idtype)
    c, kp = v.lf(k[:-1])
    kb, kf, sz = v.set_intv(torch.arange(1, 5))
    ext = [[t.numpy() for t in v.extend6(kb, kf, sz, b)] for b in (0, 1)]
    res[kind] = dict(idtype=str(idx.idtype), rows=v.packed_l.shape[0],
                     fused=v.fused_l is not None,
                     rank6=v.rank6(k).numpy(), sym=v.sym_at(k[:-1]).numpy(),
                     lf_c=c.numpy(), lf_k=kp.numpy(), ext=ext)

idx = index("int32")
qs = split(D["q"], D["qoff"])
eng = sh.ShardedSMEM(idx, mesh)
res["smem"] = eng.smem_all(qs)
res["smem_self"] = eng.smem_all(qs, self_match=True)
before = sm.STATS["redo"]
res["smem_ladder"] = sh.ShardedSMEM(idx, mesh).smem_all(qs, maxi=4, maxm=8)
res["ladder_redo"] = sm.STATS["redo"] - before
res["smem_long"] = eng.smem_all(split(D["lq"], D["lqoff"]))

e0 = fmd.FMDIndex.from_bwt(D["b0"], "cpu")
e1 = fmd.FMDIndex.from_bwt(D["b1"], "cpu")
res["merge"] = sh.fm_merge_sharded(e0, D["b0"], e1, D["b1"], mesh, batch=16)
res["interleave"] = sh.interleave_device(mesh, D["rb0"], D["rb1"],
                                         D["rbits"])
texts = split(D["t"], D["toff"])
res["build_left"] = sh.build_fmd_distributed([None] + texts[1:], mesh)
res["build_right"] = sh.build_fmd_distributed(
    texts[:1] + [None] + texts[2:], mesh)
try:
    sh.build_fmd_distributed([None] * len(texts), mesh)
except ValueError as e:
    res["build_none"] = str(e)

blocks, occ = sh.pad_index_for_tp(idx.bwt_blocks, idx.occ, tp)
L = blocks.shape[0] // tp
t = mesh.tp_rank
keys = torch.arange(idx.total + 1, dtype=idx.idtype).tensor_split(dp)
kq = keys[mesh.dp_rank]
res["rank6_keys"] = kq.numpy()
res["sharded_rank6"] = sh.sharded_rank6(mesh)(
    blocks[t * L:(t + 1) * L], occ[t * L:(t + 1) * L], kq).numpy()
cs = torch.from_numpy(D["step_c"][:len(kq)]).long()
lq = (kq + 5).clamp(max=idx.total - 1)
res["step_l"] = lq.numpy()
res["step"] = [x.numpy() for x in sh.sharded_backward_search_step(mesh)(
    blocks[t * L:(t + 1) * L], occ[t * L:(t + 1) * L], idx.cnt, kq, lq,
    cs)]
res["all_reduce"] = sh.STATS["all_reduce"]
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def _encode(reads):
    return [dna.encode(s) for s in reads]


def _flat(seqs):
    off = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    return np.concatenate(seqs).astype(np.uint8), off.astype(np.int64)


@pytest.fixture(scope="module")
def data():
    """The inputs, and fermi_tpu's single-device answers."""
    idx_reads = random_reads(160, seed=5, with_genome=True, genome_len=4000)
    rng = np.random.default_rng(33)
    queries = []
    for s in random_reads(50, seed=21, with_genome=True, genome_len=4000):
        b = list(s)
        for _ in range(rng.integers(0, 3)):
            b[rng.integers(0, len(b))] = "ACGT"[rng.integers(0, 4)]
        queries.append("".join(b))
    bwt = suffix.multistring_bwt(suffix.build_text(_encode(idx_reads)))
    # NB + 1 rank rows not a multiple of tp = 2
    while ((len(bwt) + 127) // 128 + 1) % 2 == 0:
        idx_reads = idx_reads[:-1]
        bwt = suffix.multistring_bwt(suffix.build_text(_encode(idx_reads)))
    q = _encode(queries)
    long_q = [dna.encode(random_reads(1, 600, 601, seed=s)[0])
              for s in (1, 2)]
    r0 = random_reads(60, seed=7, with_genome=True, genome_len=1500)
    r1 = random_reads(40, seed=8, with_genome=True, genome_len=1500)
    b0 = suffix.multistring_bwt(suffix.build_text(_encode(r0)))
    b1 = suffix.multistring_bwt(suffix.build_text(_encode(r1)))
    e0, e1 = JIndex.from_bwt(b0), JIndex.from_bwt(b1)
    irng = np.random.default_rng(2)
    rb0 = irng.integers(0, 6, 777).astype(np.uint8)
    rb1 = irng.integers(0, 6, 555).astype(np.uint8)
    rbits = np.zeros(777 + 555, bool)
    rbits[irng.choice(777 + 555, 555, replace=False)] = True
    breads = _encode(random_reads(60, min_len=40, max_len=70, seed=3,
                                  with_genome=True, genome_len=900))
    per = (len(breads) + 3) // 4
    parts = [breads[i * per:(i + 1) * per] for i in range(4)]
    texts = [suffix.build_text(p) for p in parts]
    index = JIndex.from_bwt(bwt)
    n = len(bwt)
    k = jnp.arange(n + 1, dtype=jnp.int64)
    jc, jk = index.lf(k[:-1])
    kb, kf, sz = index.set_intv(jnp.arange(1, 5))
    D = dict(bwt=bwt, b0=b0, b1=b1, rb0=rb0, rb1=rb1, rbits=rbits,
             step_c=np.random.default_rng(4).integers(0, 6, n + 1))
    D["q"], D["qoff"] = _flat(q)
    D["lq"], D["lqoff"] = _flat(long_q)
    D["t"], D["toff"] = _flat(texts)
    return dict(
        D=D, index=index, queries=q, long_queries=long_q, n=n,
        rank6=np.asarray(index.rank6(k)), sym=np.asarray(index.sym_at(k[:-1])),
        lf_c=np.asarray(jc), lf_k=np.asarray(jk),
        ext=[[np.asarray(t) for t in index.extend6(kb, kf, sz, b)]
             for b in (False, True)],
        smem=smem_all(index, q), smem_self=smem_all(index, q, self_match=True),
        smem_long=smem_all(index, long_q),
        merge=fm_merge(e0, b0, e1, b1),
        gap_bits=compute_gap_bits(e0, e1),
        interleave=merge_bwts(rb0, rb1, rbits),
        build_left=suffix.multistring_bwt(suffix.build_text(
            [s for p in parts[1:] for s in p])),
        build_right=suffix.multistring_bwt(suffix.build_text(
            parts[0] + [s for p in parts[2:] for s in p])),
        build_parts=parts)


def _spawn(tmp, D, dp, tp):
    """dp·tp worker processes over gloo; their result dicts by rank."""
    inp = str(tmp / "in.npz")
    np.savez(inp, **D)
    world = dp * tp
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         "file://" + str(tmp / "init"), inp, str(tmp / f"out{r}.pkl"),
         str(dp), str(tp)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
            errs.append(err.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{errs[r]}"
    out = []
    for r in range(world):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module", params=SHAPES,
                ids=[f"dp{d}tp{t}" for d, t in SHAPES])
def ranks(request, data, tmp_path_factory):
    dp, tp = request.param
    return dp, tp, _spawn(tmp_path_factory.mktemp(f"dp{dp}tp{tp}"),
                          data["D"], dp, tp)


def test_make_mesh(ranks):
    dp, tp, out = ranks
    world = dp * tp
    for r, res in enumerate(out):
        assert res["mesh_default"] == {"dp": world, "tp": 1}
        assert res["mesh_dp"] == {"dp": dp, "tp": world // dp}
        assert res["mesh_tp"] == {"dp": world // tp, "tp": tp}
        assert "needs" in res["oversize"]
        assert res["place"] == (r // tp, r % tp, "gloo")


@pytest.mark.parametrize("kind", ["int32", "int64", "unfused"])
def test_tp_view_rank_sym_lf(ranks, data, kind):
    """Every position, through the view's K1 partials and the all-reduce:
    FMDIndex's rank6, sym_at, lf and extend6."""
    dp, tp, out = ranks
    for res in out:
        got = res[kind]
        assert got["idtype"] == ("torch.int32" if kind != "int64"
                                 else "torch.int64")
        assert got["fused"] == (kind != "unfused")
        assert got["rows"] == -(-((data["n"] + 127) // 128 + 1) // tp)
        assert np.array_equal(got["rank6"], data["rank6"])
        assert np.array_equal(got["sym"], data["sym"])
        assert np.array_equal(got["lf_c"], data["lf_c"])
        assert np.array_equal(got["lf_k"], data["lf_k"])
        for g, w in zip(got["ext"], data["ext"]):
            for a, b in zip(g, w):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("self_match", [False, True])
def test_sharded_smem(ranks, data, self_match):
    _, _, out = ranks
    key = "smem_self" if self_match else "smem"
    assert sum(map(len, data[key])) > len(data["queries"])
    for res in out:
        assert res[key] == data[key]


def test_sharded_smem_redo_ladder(ranks, data):
    """maxi=4, maxm=8 send reads up the redo ladder on every dp group."""
    _, _, out = ranks
    for res in out:
        assert res["ladder_redo"] > 0
        assert res["smem_ladder"] == data["smem"]


def test_sharded_smem_long_queries_go_native(ranks, data):
    _, _, out = ranks
    for res in out:
        assert res["smem_long"] == data["smem_long"]


def test_sharded_smem_equals_fermi_tpu_sharded(ranks, data):
    """fermi_tpu's ShardedSMEM on the same dp×tp shape of the virtual
    mesh gives what the port's ranks give."""
    dp, tp, out = ranks
    mesh = jsh.make_mesh(dp=dp, tp=tp)
    want = jsh.ShardedSMEM(data["index"], mesh).smem_all(data["queries"])
    assert out[0]["smem"] == want


def test_fm_merge_sharded(ranks, data):
    _, _, out = ranks
    for res in out:
        assert np.array_equal(res["merge"], data["merge"])
    assert data["gap_bits"].sum() == len(data["D"]["b1"])


def test_interleave_device(ranks, data):
    _, _, out = ranks
    for res in out:
        assert np.array_equal(res["interleave"], data["interleave"])


@pytest.mark.parametrize("side", ["left", "right"])
def test_build_fmd_distributed_none_shard(ranks, data, side):
    """A None shard on either side of a pair is absent: the result is the
    BWT of the other shards' concatenation (fermi_tpu handles the right
    side only, sharded.py:418-431)."""
    _, _, out = ranks
    for res in out:
        assert np.array_equal(res[f"build_{side}"], data[f"build_{side}"])
        assert "no shard" in res["build_none"]


def test_sharded_rank6_and_search_step(ranks, data):
    dp, tp, out = ranks
    idx = data["index"]
    for res in out:
        k = res["rank6_keys"]
        assert np.array_equal(res["sharded_rank6"], data["rank6"][k])
        c = data["D"]["step_c"][:len(k)]
        l = res["step_l"]
        ok, ol = data["rank6"][k], data["rank6"][l + 1]
        cnt = np.asarray(idx.cnt)
        nk = cnt[c] + ok[np.arange(len(k)), c]
        nl = cnt[c] + ol[np.arange(len(k)), c] - 1
        alive = nk <= nl
        gk, gl, ga = res["step"]
        assert np.array_equal(ga, alive)
        assert np.array_equal(gk, np.where(alive, nk, k))
        assert np.array_equal(gl, np.where(alive, nl, l))
        if tp > 1:
            assert res["all_reduce"] > 0


def test_fermi_tpu_none_shard_fault(data):
    """fermi_tpu's build_fmd_distributed fails on a None shard on the left
    of a pair (sharded.py:430); the port does not copy that."""
    mesh = jsh.make_mesh(dp=2, tp=1)
    texts = [suffix.build_text(p) for p in data["build_parts"]]
    with pytest.raises(TypeError):
        jsh.build_fmd_distributed([None] + texts[1:], mesh)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, capsys):
    from fermi_tpu_torch.graft_entry import dryrun_multichip

    res = dryrun_multichip(n, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    dp = max(n // 2, 1)
    assert f"ok: mesh dp={dp} tp={n // dp}" in capsys.readouterr().out
    assert [r["rank"] for r in res] == list(range(n))
    assert all(r["backend"] == "gloo" and r["all_reduce"] > 0 for r in res)


def test_entry_runs_one_smem_batch():
    """entry()'s pass gives smem_all's SMEMs for every read whose buffers
    held (the others would ride the redo ladder)."""
    from fermi_tpu_torch.graft_entry import entry
    from fermi_tpu_torch.search import smem as tsm

    fn, (index, q, lens) = entry(device="cpu")
    g3, mem_n, _, ovf = fn(index, q, lens)
    assert g3.shape == (32, 64, 3) and not ovf.all()
    dec = tsm._decode_batch(g3.numpy(), mem_n.numpy())
    seqs = [q[i, :lens[i]].numpy() for i in range(32)]
    want = tsm.smem_all(index, seqs)
    assert [d for d, o in zip(dec, ovf) if not o] == \
        [w for w, o in zip(want, ovf) if not o]
