"""Independent float64 NumPy transliteration of the reference objective.

Follows the Theano graph ``reference: SCFGP/SCFGP.py:74-128`` literally —
explicit matrix inverse, 30-node Gauss–Hermite quadrature, no closed forms —
to serve as the golden parity anchor for the JAX implementation (SURVEY.md §4
item 2).  Deliberately written with different primitives (np.linalg.inv,
einsum-free loops where cheap) so a shared bug is unlikely.
"""

import numpy as np


def golden_cost(theta, X, y, D, S, M):
    """cost = (nlml + penalty)/N for the flat parameter vector ``theta``."""
    epsilon = 1e-6
    i = 0
    a = theta[0]; b = theta[1]; c = theta[2]; i = 3
    l_F = theta[i:i + D * S].reshape(D, S); i += D * S
    r_F = theta[i:i + M * S].reshape(M, S); i += M * S
    l_p = theta[i:i + S]; i += S
    p = theta[i:i + M]; i += M
    F = l_F.dot(r_F.T)
    l_FC = l_p[None, :] - np.mean(l_F, axis=0)[None, :]
    FC = p[None, :] - np.mean(F, axis=0)[None, :]

    sig2_n, sig_f = np.exp(2 * a), np.exp(b)
    l_FF = X.dot(l_F) + l_FC
    FF = np.concatenate((l_FF, X.dot(F) + FC), axis=1)
    Phi = np.concatenate((np.cos(FF), np.sin(FF)), axis=1)
    Phi = sig_f * np.sqrt(2.0 / M) * Phi
    noise = np.log(1 + np.exp(c))
    PhiTPhi = Phi.T.dot(Phi)
    A = PhiTPhi + (sig2_n + epsilon) * np.eye(PhiTPhi.shape[0])
    L = np.linalg.cholesky(A)
    Li = np.linalg.inv(L)
    PhiTy = Phi.T.dot(y)
    beta = Li.dot(PhiTy)
    alpha = Li.T.dot(beta)
    mu_f = Phi.dot(alpha)
    var_f = (Phi.dot(Li.T) ** 2).sum(1)[:, None]
    dsp = noise * (var_f + 1)
    mu_l = np.sum(np.mean(l_F, axis=1))
    sig_l = np.sum(np.std(l_F, axis=1))
    mu_w = np.sum(np.mean(F, axis=1))
    sig_w = np.sum(np.std(F, axis=1))
    hx, hw = np.polynomial.hermite.hermgauss(30)
    herm_x = hx[None, None, :]
    herm_w = (hw / np.sqrt(np.pi))[None, None, :]
    herm_f = np.sqrt(2 * var_f[:, :, None]) * herm_x + mu_f[:, :, None]
    nlk = ((0.5 * herm_f**2 - y[:, :, None] * herm_f) / dsp[:, :, None]
           + 0.5 * (np.log(2 * np.pi * dsp[:, :, None])
                    + y[:, :, None]**2 / dsp[:, :, None]))
    enll = herm_w * nlk
    nlml = (2 * np.log(np.diagonal(L)).sum() + 2 * enll.sum()
            + 1.0 / sig2_n * ((y**2).sum() - (beta**2).sum())
            + 2 * (X.shape[0] - M) * a)
    kl = lambda mu, sig: sig + mu**2 - np.log(sig)
    penalty = (kl(mu_w, sig_w) * M + kl(mu_l, sig_l) * S) / (S + M)
    return (nlml + penalty) / X.shape[0]


def golden_features(theta, X, D, S, M):
    """Trig feature map transliteration (reference SCFGP.py:88-102)."""
    i = 3
    b = theta[1]
    l_F = theta[i:i + D * S].reshape(D, S); i += D * S
    r_F = theta[i:i + M * S].reshape(M, S); i += M * S
    l_p = theta[i:i + S]; i += S
    p = theta[i:i + M]; i += M
    F = l_F.dot(r_F.T)
    l_FC = l_p[None, :] - np.mean(l_F, axis=0)[None, :]
    FC = p[None, :] - np.mean(F, axis=0)[None, :]
    FF = np.concatenate((X.dot(l_F) + l_FC, X.dot(F) + FC), axis=1)
    Phi = np.concatenate((np.cos(FF), np.sin(FF)), axis=1)
    return np.exp(b) * np.sqrt(2.0 / M) * Phi


def golden_predict(theta, Xs, D, S, M, alpha, Li):
    """Predictive mean/std transliteration (reference SCFGP.py:138-148)."""
    noise = np.log(1 + np.exp(theta[2]))
    Phis = golden_features(theta, Xs, D, S, M)
    mu = Phis.dot(alpha)
    std = (noise * (1 + (Phis.dot(Li.T) ** 2).sum(1))) ** 0.5
    return mu, std
