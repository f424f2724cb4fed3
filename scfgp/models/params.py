"""Parameter PyTree for the SCFGP model.

The reference packs every hyperparameter into ONE flat Theano shared vector
(``reference: SCFGP/SCFGP.py:64-90``).  Here we keep a structured PyTree —
JAX transforms (grad/jit/vmap/shard_map) operate on PyTrees natively and XLA
lays each leaf out independently — but we preserve an exact flat-vector
pack/unpack so that

  * golden parity tests can drive both implementations from one vector, and
  * HMC/NUTS (which wants a flat position vector) gets it for free.

Layout of the flat vector (identical to reference ``SCFGP.py:72``):
  ``concat([a, b, c, l_F.ravel(D*S), r_F.ravel(M*S), l_phase(S), phase(M)])``
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SCFGPParams(NamedTuple):
    """Trainable hyperparameters of the sparsely-correlated Fourier GP.

    Shapes: ``l_F (D, S)``, ``r_F (M, S)``, ``l_phase (S,)``, ``phase (M,)``,
    scalars ``a`` (noise: sig2_n = exp(2a)), ``b`` (amplitude: sig_f = exp(b)),
    ``c`` (dispersion: noise = softplus(c)).
    """

    a: jax.Array
    b: jax.Array
    c: jax.Array
    l_F: jax.Array
    r_F: jax.Array
    l_phase: jax.Array
    phase: jax.Array

    @property
    def D(self) -> int:
        return self.l_F.shape[0]

    @property
    def S(self) -> int:
        return self.l_F.shape[1]

    @property
    def M(self) -> int:
        return self.r_F.shape[0]


def resolve_sparsity(S: int, D: int, M: int) -> int:
    """Map the legacy full-rank sentinel to an effective rank.

    The reference's v0.1.0 API accepted ``rank=-1`` for an unfactorized
    frequency matrix (``reference: experiments/boston_housing/
    test_regression.py:37``, BASELINE config "rank=full").  With the low-rank
    product ``F = l_F r_F^T``, rank ``min(D, M)`` spans ALL D x M matrices,
    so ``S=-1`` maps there — full rank inside the same parameterization.
    """
    return min(D, M) if S == -1 else S


def init_params(key: jax.Array, D: int, S: int, M: int,
                dtype=jnp.float32) -> SCFGPParams:
    """Random init matching the reference distributionally.

    Reference (``SCFGP/SCFGP.py:64-72``): a,b,c,l_F ~ N(0,1); r_F ~ U(0,1);
    phases ~ U(0, 2*pi).  ``S=-1`` selects full rank (see
    ``resolve_sparsity``).
    """
    S = resolve_sparsity(S, D, M)
    ka, kb, kc, kl, kr, kp1, kp2 = jax.random.split(key, 7)
    two_pi = 2.0 * np.pi
    return SCFGPParams(
        a=jax.random.normal(ka, (), dtype),
        b=jax.random.normal(kb, (), dtype),
        c=jax.random.normal(kc, (), dtype),
        l_F=jax.random.normal(kl, (D, S), dtype),
        r_F=jax.random.uniform(kr, (M, S), dtype),
        l_phase=two_pi * jax.random.uniform(kp1, (S,), dtype),
        phase=two_pi * jax.random.uniform(kp2, (M,), dtype),
    )


def pack_params(p: SCFGPParams) -> jax.Array:
    """PyTree -> flat vector (reference layout, ``SCFGP.py:72``)."""
    return jnp.concatenate([
        jnp.reshape(p.a, (1,)),
        jnp.reshape(p.b, (1,)),
        jnp.reshape(p.c, (1,)),
        p.l_F.reshape(-1),
        p.r_F.reshape(-1),
        p.l_phase,
        p.phase,
    ])


def unpack_params(theta: jax.Array, D: int, S: int, M: int) -> SCFGPParams:
    """Flat vector -> PyTree (reference layout, ``SCFGP.py:74-90``)."""
    i = 3
    l_F = theta[i:i + D * S].reshape(D, S); i += D * S
    r_F = theta[i:i + M * S].reshape(M, S); i += M * S
    l_phase = theta[i:i + S]; i += S
    phase = theta[i:i + M]; i += M
    return SCFGPParams(a=theta[0], b=theta[1], c=theta[2],
                       l_F=l_F, r_F=r_F, l_phase=l_phase, phase=phase)


def num_params(D: int, S: int, M: int) -> int:
    return 3 + D * S + M * S + S + M


class DerivedFrequencies(NamedTuple):
    """Quantities derived from params once per step.

    ``F = l_F @ r_F.T`` is the low-rank frequency matrix (``SCFGP.py:83``);
    phase offsets are mean-centered (``SCFGP.py:88-89``).  ``Fcat (D, S+M)``
    and ``pcat (S+M,)`` fuse the two projections ``[X @ l_F | X @ F]`` into a
    single GEMM.
    """

    F: jax.Array        # (D, M)
    Fcat: jax.Array     # (D, S+M) = [l_F | F]
    pcat: jax.Array     # (S+M,)   = [l_phase - mean(l_F, 0) | phase - mean(F, 0)]


def derive_frequencies(p: SCFGPParams) -> DerivedFrequencies:
    F = p.l_F @ p.r_F.T                      # (D, M) low-rank product
    l_FC = p.l_phase - jnp.mean(p.l_F, axis=0)
    FC = p.phase - jnp.mean(F, axis=0)
    Fcat = jnp.concatenate([p.l_F, F], axis=1)
    pcat = jnp.concatenate([l_FC, FC], axis=0)
    return DerivedFrequencies(F=F, Fcat=Fcat, pcat=pcat)
