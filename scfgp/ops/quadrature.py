"""Gauss–Hermite quadrature utilities.

The reference computes the expected negative log-likelihood with a 30-node
Gauss–Hermite rule (``reference: SCFGP/SCFGP.py:118-124``).  The production
objective uses the exact closed form (see
``scfgp.models.objective.expected_nll_rows``); this module keeps the
literal quadrature available for (a) golden parity tests and (b) future
non-Gaussian likelihoods where no closed form exists.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=None)
def hermgauss(n: int = 30):
    """Nodes and probabilist-normalized weights (w / sqrt(pi)), host constants."""
    x, w = np.polynomial.hermite.hermgauss(n)
    return x, w / np.sqrt(np.pi)


def expected_nll_rows_gh(mu_f, var_f, y, noise, n_nodes: int = 30):
    """Literal transliteration of the reference quadrature (SCFGP.py:118-124).

    ``E_{f~N(mu, var)}[nll(f, y)]`` per row via an (N, n_nodes) node tensor.
    Equal to the closed form up to quadrature round-off (the integrand is
    quadratic in f, so a >=2-node rule is exact in real arithmetic).
    """
    x, w = hermgauss(n_nodes)
    x = jnp.asarray(x, mu_f.dtype)[None, :]
    w = jnp.asarray(w, mu_f.dtype)[None, :]
    y = y.reshape(-1, 1)
    mu = mu_f.reshape(-1, 1)
    var = var_f.reshape(-1, 1)
    dsp = noise * (var + 1.0)
    herm_f = jnp.sqrt(2.0 * var) * x + mu
    nlk = ((0.5 * herm_f**2 - y * herm_f) / dsp
           + 0.5 * (jnp.log(2.0 * np.pi * dsp) + y**2 / dsp))
    return jnp.sum(w * nlk, axis=1)
