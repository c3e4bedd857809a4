"""The paper's §6.1 and §6.5 networks in the port against the JAX package.

``tests/test_system.py``'s ``TestConcordance`` (a four-stage pipeline over
a word list), ``TestGoldbach`` (``EmitWithLocal`` → farm → ``ListSeqOne``
→ Collect) and ``TestCastCombine`` (``OneSeqCastList`` / ``OneParCastList``
into branch workers, folded by ``CombineNto1`` or merged by
``AnyFanOne``), each built in both packages from the same user methods
written once per array library.  The port must verify the same networks,
give one answer in its sequential oracle and its fused run
(``device="cpu"``), and that answer must be the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore

CPU = "cpu"


def _both(jnet, tnet, n):
    """(JAX sequential, JAX fused, port sequential, port fused) results of
    the Collect named ``collect``, as Python scalars."""
    jcore.verify(jnet)
    tcore.verify(tnet)
    return (jcore.run_sequential(jnet, n)["collect"].item(),
            jcore.build(jnet).run(instances=n)["collect"].item(),
            tcore.run_sequential(tnet, n, device=CPU)["collect"].item(),
            tcore.build(tnet, device=CPU).run(instances=n)["collect"].item())


# --------------------------------------------------------------------------
# Concordance (paper §6.1): a four-stage pipeline
# --------------------------------------------------------------------------

TEXT = ("the quick brown fox jumps over the lazy dog the fox "
        "the quick dog runs").split()
VOCAB = sorted(set(TEXT))
WORD_IDS = [VOCAB.index(w) for w in TEXT]
V = len(VOCAB)


def _concordance_jax():
    ids = jnp.asarray(WORD_IDS, jnp.int32)

    def value_list(n):  # sums of n consecutive word values, -1 padded
        L = ids.shape[0]
        csum = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(ids)])
        idx = jnp.arange(L)
        return n, jnp.where(idx + n <= L,
                            csum[jnp.minimum(idx + n, L)] - csum[idx], -1)

    def indices_map(item):  # histogram of the values
        n, vals = item
        hist = jnp.zeros(V * 8, jnp.int32).at[
            jnp.clip(vals, 0, V * 8 - 1)].add((vals >= 0).astype(jnp.int32))
        return n, vals, hist

    def words_map(item):  # count of repeated strings
        n, _, hist = item
        return n, jnp.sum(jnp.where(hist > 1, hist, 0))

    return jcore.OnePipelineCollect(
        create=lambda n: jnp.asarray(n + 1, jnp.int32),
        stage_ops=[value_list, indices_map, words_map],
        collector=lambda acc, item: acc + item[1],
        init=jnp.asarray(0, jnp.int32), jit_combine=True,
        name="concordance")


def _concordance_torch():
    ids = torch.tensor(WORD_IDS, dtype=torch.int32)

    def value_list(n):
        L = ids.shape[0]
        csum = torch.cat([torch.zeros(1, dtype=torch.int32),
                          torch.cumsum(ids, 0).to(torch.int32)])
        idx = torch.arange(L)
        return n, torch.where(idx + n <= L,
                              csum[torch.clamp(idx + n, max=L)] - csum[idx],
                              -1)

    def indices_map(item):
        n, vals = item
        hist = torch.zeros(V * 8, dtype=torch.int32).index_add_(
            0, vals.clamp(0, V * 8 - 1).long(), (vals >= 0).to(torch.int32))
        return n, vals, hist

    def words_map(item):
        n, _, hist = item
        return n, torch.where(hist > 1, hist, 0).sum().to(torch.int32)

    return tcore.OnePipelineCollect(
        create=lambda n: torch.tensor(n + 1, dtype=torch.int32),
        stage_ops=[value_list, indices_map, words_map],
        collector=lambda acc, item: acc + item[1],
        init=torch.tensor(0, dtype=torch.int32), jit_combine=True,
        name="concordance")


def test_concordance_pipeline_matches_jax():
    jseq, jpar, seq, par = _both(_concordance_jax(), _concordance_torch(), 3)
    assert seq == par == jseq == jpar
    assert seq > 0  # repeated strings exist ("the", "the quick", ...)


# --------------------------------------------------------------------------
# Goldbach (paper §6.5): EmitWithLocal, a farm, ListSeqOne, a Collect
# --------------------------------------------------------------------------

MAXN = 60


def _primes():
    sieve = np.ones(MAXN + 1, bool)
    sieve[:2] = False
    for p in range(2, int(MAXN ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    return np.flatnonzero(sieve)


def _goldbach(lib):
    """The reference's network in ``lib`` (``jcore`` or ``tcore``): each
    worker checks 8 even numbers from its item's ``lo``."""
    primes = _primes()
    if lib is jcore:
        padded = jnp.asarray(np.pad(primes, (0, 32 - len(primes))))

        def get_range(lo):
            es = lo + 2 * jnp.arange(8)
            isp = jnp.zeros(MAXN * 2 + 1, bool).at[padded].set(
                jnp.arange(32) < len(primes))

            def ok(e):
                cand = jnp.arange(2, MAXN + 1)
                return jnp.any(isp[cand] & isp[jnp.maximum(e - cand, 0)]
                               & (cand <= e - 2) & (e <= MAXN))

            return jax.vmap(ok)(es) | (es > MAXN)

        as_int, true = (lambda v: jnp.asarray(v, jnp.int32),
                        jnp.asarray(True))
        collector = lambda acc, oks: jnp.logical_and(acc, jnp.all(oks))
    else:
        prime_idx = torch.from_numpy(primes)

        def get_range(lo):
            es = lo + 2 * torch.arange(8)
            isp = torch.zeros(MAXN * 2 + 1, dtype=torch.bool)
            isp[prime_idx] = True
            cand = torch.arange(2, MAXN + 1)[None, :]
            e = es[:, None]
            ok = (isp[cand] & isp[torch.clamp(e - cand, min=0)]
                  & (cand <= e - 2) & (e <= MAXN)).any(dim=-1)
            return ok | (es > MAXN)

        as_int, true = (lambda v: torch.tensor(v, dtype=torch.int32),
                        torch.tensor(True))
        collector = lambda acc, oks: torch.logical_and(acc, oks.all())

    net = lib.Network("goldbach")
    net.add(lib.EmitWithLocal(lambda i, local: (as_int(4 + 2 * (i * 8)),
                                                local),
                              lambda: 0, name="emit"),
            lib.OneFanAny(name="fan"),
            lib.Worker(get_range, name="group"),
            lib.ListSeqOne(name="merge"),
            lib.Collect(collector, init=true, jit_combine=True,
                        name="collect"))
    return net


def test_goldbach_network_matches_jax():
    results = _both(_goldbach(jcore), _goldbach(tcore), 4)
    assert results == (True, True, True, True)  # it holds below 60


# --------------------------------------------------------------------------
# Casts and CombineNto1 (Goldbach's prime-distribution phase, abstracted)
# --------------------------------------------------------------------------

def _cast_net(lib, scalar, cast, join):
    """Emit → ``cast`` → two branch workers → ``join`` → Collect; a
    ``CombineNto1`` join folds the branches by addition."""
    net = lib.Network("cast")
    if join == "combine":
        net.add(lib.Emit(lambda i: scalar(float(i + 1)), name="e"),
                getattr(lib, cast)(name="cast"))
        w1, w2 = (lambda x: x * 2), (lambda x: x * 3)
    else:
        net.add(lib.Emit(lambda i: scalar(1.0), name="e"),
                getattr(lib, cast)(name="cast"))
        w1 = w2 = (lambda x: x)
    net.procs["w1"] = lib.Worker(w1, name="w1", tag="w1")
    net.procs["w2"] = lib.Worker(w2, name="w2", tag="w2")
    net.connect("cast", "w1")
    net.connect("cast", "w2")
    net.procs["m"] = (lib.CombineNto1(lambda a, b: a + b, name="m")
                      if join == "combine" else lib.AnyFanOne(name="m"))
    net.connect("w1", "m")
    net.connect("w2", "m")
    net._tail = "m"
    net.add(lib.Collect(lambda a, x: a + x, init=scalar(0.0),
                        jit_combine=True, name="collect"))
    return net


@pytest.mark.parametrize("cast,join,n,want", [
    ("OneSeqCastList", "combine", 4, 50.0),  # each item i: 2i + 3i
    ("OneSeqCastList", "merge", 3, 6.0),     # each item twice
    ("OneParCastList", "merge", 3, 6.0),
])
def test_cast_networks_match_jax(cast, join, n, want):
    jnet = _cast_net(jcore, lambda v: jnp.asarray(v), cast, join)
    tnet = _cast_net(tcore, lambda v: torch.tensor(v), cast, join)
    assert _both(jnet, tnet, n) == (want,) * 4
