"""The ferromagnetic chain's exact equilibrium.

Counterpart of `ising_gibbs_windows` in the JAX package's
`models/ferromagnet.py` (numpy, so a copy). The rest of that module, the
analytic island ODE and the Metropolis chain, is ROADMAP Queue 1's
"Companion simulators".
"""

from __future__ import annotations

import numpy as np


def ising_gibbs_windows(cl_k, *, J_eff, h, beta):
    """Exact length-``cl_k`` window probabilities of the infinite-chain
    1D Ising Gibbs measure (transfer matrix; symbol 0 = D = spin -1,
    1 = U = +1): the equilibrium ex2's tape rule relaxes to, at
    ``J_eff = 2J`` (its flip rates are detailed-balanced against
    H = -J_eff sum s s' - h sum s). Order-1 Markov, so an exact root of
    the closure's dp/dt for any cl_k >= 2. A flat float64 ``[2**cl_k]``
    array."""
    sv = np.array([-1.0, 1.0])
    T = np.exp(beta * (J_eff * np.outer(sv, sv)
                       + h * (sv[:, None] + sv[None, :]) / 2))
    w, V = np.linalg.eig(T)
    i = int(np.argmax(w.real))
    lam, r = w.real[i], V[:, i].real
    wl, Vl = np.linalg.eig(T.T)
    left = Vl[:, int(np.argmax(wl.real))].real
    if (left @ r) < 0:
        r = -r

    def window(bits):
        v = left[bits[0]] * r[bits[-1]]
        for a, b in zip(bits[:-1], bits[1:]):
            v *= T[a, b] / lam
        return v / (left @ r)

    p = np.array([window([(idx >> (cl_k - 1 - j)) & 1
                          for j in range(cl_k)])
                  for idx in range(2 ** cl_k)])
    return p / p.sum()
