"""The N-body engine (paper §6.3) in the port against the JAX package's.

``tests/test_engines.py::TestNBody`` on the port: an ``IterativeEngine``
with a fixed number of iterations (no tolerance loop), whose partitions
each read every body and update their own rows.  The same numpy-seeded
bodies go through both packages at 1 and 4 nodes; the port must keep the
reference's own checks (momentum conserved, the result independent of the
node count) and agree with the JAX engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IterativeEngine as JIterativeEngine, rows
from repro_torch.core import IterativeEngine, narrow

DT = 1e-3


def _jax_engine(n, nodes, iterations):
    def partition(state, lo, size):
        return {"pos": state["pos"], "vel": rows(state["vel"], lo, size),
                "mass": state["mass"],
                "my_pos": rows(state["pos"], lo, size)}

    def calculation(part):
        diff = part["pos"][None, :, :] - part["my_pos"][:, None, :]
        r2 = jnp.sum(diff * diff, axis=-1) + 1e-3
        acc = jnp.einsum("ijk,ij,j->ik", diff, r2 ** -1.5, part["mass"])
        return part["vel"] + DT * acc

    def update(state, new_vel):
        return {**state, "vel": new_vel, "pos": state["pos"] + DT * new_vel}

    return JIterativeEngine(partition=partition, calculation=calculation,
                            update=update, n_rows=n, nodes=nodes,
                            iterations=iterations)


def _engine(n, nodes, iterations):
    def partition(state, lo, size):
        return {"pos": state["pos"], "vel": narrow(state["vel"], lo, size),
                "mass": state["mass"],
                "my_pos": narrow(state["pos"], lo, size)}

    def calculation(part):
        # acceleration on my partition from ALL bodies (shared read)
        diff = part["pos"][None, :, :] - part["my_pos"][:, None, :]
        r2 = torch.sum(diff * diff, dim=-1) + 1e-3
        acc = torch.einsum("ijk,ij,j->ik", diff, r2 ** -1.5, part["mass"])
        return part["vel"] + DT * acc

    def update(state, new_vel):
        return {**state, "vel": new_vel, "pos": state["pos"] + DT * new_vel}

    return IterativeEngine(partition=partition, calculation=calculation,
                           update=update, n_rows=n, nodes=nodes,
                           iterations=iterations)


def _bodies(n, seed, unit_mass):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = (np.ones(n, np.float32) if unit_mass
            else (rng.random(n) + 0.5).astype(np.float32))
    return {"pos": pos, "vel": np.zeros((n, 3), np.float32), "mass": mass}


def _torch(state):
    return {k: torch.from_numpy(v) for k, v in state.items()}


@pytest.mark.parametrize("nodes", [1, 4])
def test_nbody_matches_jax(nodes):
    """Positions and velocities after 10 iterations equal the JAX
    engine's within float32 reassociation."""
    state = _bodies(16, 0, unit_mass=False)
    want = jax.jit(_jax_engine(16, nodes, 10).apply)(
        {k: jnp.asarray(v) for k, v in state.items()})
    got = _engine(16, nodes, 10).apply(_torch(state))
    for name in ("pos", "vel"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6)


def test_momentum_conserved():
    """Equal and opposite forces: the total momentum stays ~0 (the
    reference's bound)."""
    state = _torch(_bodies(16, 0, unit_mass=False))
    out = _engine(16, nodes=4, iterations=10).apply(state)
    p = torch.einsum("i,ik->k", state["mass"], out["vel"])
    assert float(p.abs().max()) < 1e-3


def test_node_invariance():
    """1 node and 4 nodes give the same positions (rtol 1e-5, the
    reference's)."""
    state = _torch(_bodies(8, 1, unit_mass=True))
    o1 = _engine(8, 1, 5).apply(state)
    o2 = _engine(8, 4, 5).apply(state)
    np.testing.assert_allclose(o1["pos"].numpy(), o2["pos"].numpy(),
                               rtol=1e-5)
