"""The port's search/extend.py against fermi_tpu.search.extend, bit for bit,
on the tests/test_index.py inputs (JAX on the CPU; the port on the CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fermi_tpu.construct import suffix
from fermi_tpu.core import dna
from fermi_tpu.index.fmd import FMDIndex as JIndex
from fermi_tpu.search import extend as jex
from fermi_tpu_torch.index.fmd import FMDIndex as TIndex
from fermi_tpu_torch.search import extend as tex

from util import random_reads

# The port's CPU ops are small: one thread each keeps parallel test
# workers from oversubscribing the cores, where OpenMP spin-waits
# slow every op by orders of magnitude.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    reads = random_reads(80, seed=11, with_genome=True, genome_len=3000)
    bwt = suffix.multistring_bwt(
        suffix.build_text([dna.encode(s) for s in reads]))
    return reads, JIndex.from_bwt(bwt), TIndex.from_bwt(bwt, device="cpu")


def _eq(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b))


def _queries(seqs):
    max_len = max(len(s) for s in seqs)
    q = np.zeros((len(seqs), max_len), np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        q[i, :len(s)] = s
        lens[i] = len(s)
    return q, lens, max_len


def test_backward_search(pair):
    reads, jidx, tidx = pair
    seqs = [dna.encode(s) for s in reads]
    seqs += [dna.encode(s) for s in random_reads(20, seed=3, max_len=40)]
    seqs.append(np.zeros(0, np.uint8))                 # an empty query
    q, lens, max_len = _queries(seqs)
    got = tex.backward_search(tidx, torch.from_numpy(q),
                              torch.from_numpy(lens), max_len)
    want = jex.backward_search(jidx, jnp.asarray(q), jnp.asarray(lens),
                               max_len)
    _eq(got, want)
    assert (got[2][:80] >= 1).all()      # every read occurs in the index


def test_retrieve_walks(pair):
    _, jidx, tidx = pair
    ids = np.arange(tidx.n_seqs, dtype=np.int64)
    _eq(tex.retrieve(tidx, torch.from_numpy(ids), 128),
        jex.retrieve(jidx, jnp.asarray(ids), 128))
    _eq(tex.retrieve2(tidx, torch.from_numpy(ids), 128),
        jex.retrieve2(jidx, jnp.asarray(ids), 128))
    tseqs, tk = tex.retrieve_strings(tidx, ids[::3], bound=256)
    jseqs, jk = jex.retrieve_strings(jidx, ids[::3], max_len=256)
    assert [s.tolist() for s in tseqs] == [s.tolist() for s in jseqs]
    np.testing.assert_array_equal(tk, jk)


@pytest.mark.parametrize("max_iters", [256, 30])
def test_seqrank_walk(pair, max_iters):
    # 30 is not a multiple of the unroll: lanes walk past max_iters exactly
    # as far as the JAX loop lets them
    _, jidx, tidx = pair
    ids = np.arange(0, tidx.n_seqs, 2, dtype=np.int64)
    _eq(tex.seqrank_walk(tidx, torch.from_numpy(ids), max_iters=max_iters),
        jex.seqrank_walk(jidx, jnp.asarray(ids), max_iters=max_iters))


def test_multi_backward_search(pair):
    reads, jidx, tidx = pair
    other = random_reads(40, seed=12, with_genome=True, genome_len=3000)
    bwt2 = suffix.multistring_bwt(
        suffix.build_text([dna.encode(s) for s in other]))
    j2, t2 = JIndex.from_bwt(bwt2), TIndex.from_bwt(bwt2, device="cpu")
    for s in reads[:6] + other[:6] + ["ACGTTTGCAN", "A"]:
        e = dna.encode(s[:40])
        assert tex.multi_backward_search([tidx, t2], e) == \
            jex.multi_backward_search([jidx, j2], e)
