"""The port's deprecated ``FarmScheduler`` shim, on the CPU.

The four farm cases of ``tests/test_serve.py`` run on the port's shim over
the reduced qwen2-0.5b, mamba2-2.7b and zamba2-1.2b, fed the JAX package's
``PRNGKey(0)`` weights: every request's ``generated`` equals the JAX
package's independent per-request generation (a jitted ``decode_step`` a
token).  The three shim cases of ``tests/test_serve_engine.py`` run on the
port's ``ToyLM``: the deprecation warning, ``generated`` filled on the
submitted objects, the legacy views and the ``max_new=0`` fix.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro_torch.core.stream import microbatch_plan
from repro_torch.interop import params_from_numpy
from repro_torch.serve import (FarmScheduler, LocalDecodeBackend, Request,
                               ServeEngine, build_decode_model)

TOY = ("toy", 32, 8)


def _jax_ref_gen(jmodel, jparams, prompt, n, max_len=64):
    """The JAX package's independent generation of one request."""
    c = jmodel.init_cache(1, max_len)
    dj = jax.jit(jmodel.decode_step)
    logits = None
    for t in prompt:
        logits, c = dj(jparams, c, jnp.asarray([[t]], jnp.int32))
    out = []
    for _ in range(n):
        t = int(jnp.argmax(logits[0, -1]))
        out.append(t)
        logits, c = dj(jparams, c, jnp.asarray([[t]], jnp.int32))
    return out


def _carried(arch):
    """(JAX model, JAX params, port model, the same weights in the port)."""
    jmodel = JModel(jget_config(arch, reduced=True))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model, like = build_decode_model(("model", arch, True), device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu", like=like)
    return jmodel, jparams, model, params


def _sched(model, params, n_slots, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return FarmScheduler(model, params, n_slots=n_slots, max_len=64,
                             **kw)


@pytest.fixture(scope="module")
def qwen2():
    return _carried("qwen2-0.5b")


# ==========================================================================
# tests/test_serve.py on the port
# ==========================================================================

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b",
                                  "zamba2-1.2b"])
def test_farm_matches_independent_generation(arch):
    jmodel, jparams, model, params = _carried(arch)
    sched = _sched(model, params, 3)
    reqs = [Request(rid=i, prompt=[5 + i, 7, 11], max_new=3 + i % 3)
            for i in range(6)]  # 6 requests > 3 slots forces slot reuse
    for r in reqs:
        sched.submit(r)
    done = sched.run()
    assert len(done) == 6
    for r in done:
        assert r.generated == _jax_ref_gen(jmodel, jparams, r.prompt,
                                           r.max_new), f"req {r.rid}"


def test_any_channel_work_stealing(qwen2):
    """Short requests finish early and free their slot for queued work —
    the farm never idles while the queue is non-empty (OneFanAny)."""
    _, _, model, params = qwen2
    sched = _sched(model, params, 2)
    for i in range(4):
        sched.submit(Request(rid=i, prompt=[3 + i], max_new=2))
    occupancy = []
    while sched.queue or any(s is not None for s in sched.slot_req):
        occupancy.append(sched.step())
    assert max(occupancy) == 2  # both slots active while work remains
    assert len(sched.done) == 4


def test_zero_context_prompt_decodes(qwen2):
    """A single-token prompt has no prefill context: the microbatch plan is
    empty, ``_prefill`` is never called, and the slot still decodes as the
    JAX package's independent generation does."""
    jmodel, jparams, model, params = qwen2
    sched = _sched(model, params, 2)
    assert microbatch_plan(0, sched.prefill_chunk) == []

    prefill_calls = []
    real_prefill = sched._prefill
    sched._prefill = lambda *a, **k: (prefill_calls.append(1),
                                      real_prefill(*a, **k))[1]
    sched.submit(Request(rid=0, prompt=[17], max_new=4))
    done = sched.run()
    assert prefill_calls == []  # zero context: no prefill call at all
    assert len(done) == 1
    assert done[0].generated == _jax_ref_gen(jmodel, jparams, [17], 4)


def test_prefill_handle_reaches_the_engine(qwen2):
    """The handle is what the engine calls: a multi-token prompt's context
    goes through the replaced ``_prefill`` once a chunk."""
    _, _, model, params = qwen2
    sched = _sched(model, params, 1)
    calls = []
    real_prefill = sched._prefill
    sched._prefill = lambda *a, **k: (calls.append(a[0]),
                                      real_prefill(*a, **k))[1]
    sched.submit(Request(rid=0, prompt=list(range(1, 11)), max_new=1))
    sched.run()
    assert calls == [0, 0]  # 9 context tokens in chunks of 8


def test_empty_prompt_rejected_before_slot_claim(qwen2):
    """An empty prompt is refused at submit time — never mid-admission,
    where it would leave a half-initialised slot."""
    _, _, model, params = qwen2
    sched = _sched(model, params, 1)
    with pytest.raises(ValueError, match="empty prompt"):
        sched.submit(Request(rid=0, prompt=[], max_new=2))
    assert sched.queue == []  # nothing enqueued, farm state untouched
    sched.submit(Request(rid=1, prompt=[5, 7], max_new=2))
    done = sched.run()
    assert len(done) == 1 and len(done[0].generated) == 2


# ==========================================================================
# The shim's legacy contract (tests/test_serve_engine.py)
# ==========================================================================

class _LegacyRequest:
    """What the first serving API's callers submit: a mutable object with
    rid/prompt/max_new, expecting ``generated`` to be written onto it."""

    def __init__(self, rid, prompt, max_new):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new


def _toy_oracle(model, params, req):
    eng = ServeEngine(LocalDecodeBackend(model, params, n_slots=1,
                                         max_len=64))
    eng.submit(req)
    eng.run_until_drained()
    return eng.poll(req.rid).tokens


def test_shim_warns_and_fills_generated():
    model, params = build_decode_model(TOY, device="cpu")
    with pytest.warns(DeprecationWarning, match="FarmScheduler"):
        sched = FarmScheduler(model, params, n_slots=2, max_len=64)
    reqs = [_LegacyRequest(i, [3 + i, 5], 2 + i % 2) for i in range(4)]
    for r in reqs:
        sched.submit(r)
    done = sched.run()
    assert done == reqs  # the very objects submitted, completion-ordered
    for r in reqs:
        want = _toy_oracle(model, params,
                           Request(rid=100 + r.rid, prompt=tuple(r.prompt),
                                   max_new=r.max_new))
        assert r.generated == list(want)


def test_shim_legacy_views_track_engine_state():
    model, params = build_decode_model(TOY, device="cpu")
    sched = _sched(model, params, 2)
    a = _LegacyRequest(0, [3], 5)
    b = _LegacyRequest(1, [4], 1)
    c = _LegacyRequest(2, [5], 3)
    for r in (a, b, c):
        sched.submit(r)
    assert sched.queue == [a, b, c]  # admission happens between chunks
    assert sched.slot_req == [None, None]
    n = sched.step()  # seats a+b, decodes both; b finishes (max_new=1)
    assert n == 2
    assert sched.queue == [c] and sched.slot_req == [a, None]
    assert sched.done == [b] and b.generated is not None
    sched.step()  # c takes b's freed slot
    assert sched.slot_req == [a, c]
    sched.run()
    assert len(sched.done) == 3 and sched.steps_run >= 5


def test_shim_max_new_zero_regression():
    """A ``max_new=0`` request completes at submit with zero tokens,
    without a slot or a decode step."""
    model, params = build_decode_model(TOY, device="cpu")
    sched = _sched(model, params, 1)
    r = _LegacyRequest(0, [7], 0)
    sched.submit(r)
    assert sched.done == [r] and r.generated == []
    assert sched.steps_run == 0 and sched.slot_req == [None]
