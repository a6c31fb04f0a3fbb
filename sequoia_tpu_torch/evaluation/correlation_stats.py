"""Statistical comparison of correlation coefficients (Steiger / Fisher /
Zou), vectorized over genes.

Counterpart of ``sequoia_tpu/evaluation/correlation_stats.py`` (a copy: the
port imports nothing of the JAX package).

Behavior contract: same tests as the reference's
``evaluation/CorrelationStats.py`` (Steiger's t for two dependent
correlations sharing one variable; Fisher z for independent ones; Zou
confidence intervals) — the formulas are the standard ones from Steiger
(1980) / Zou (2007).  All functions accept scalars or arrays and broadcast.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm, t as t_dist


def fisher_z_ci(r, n, conf_level: float = 0.95):
    """CI of a correlation via the Fisher z transform -> (lower, upper)."""
    r = np.asarray(r, dtype=np.float64)
    se = np.sqrt(1.0 / (n - 3))
    moe = norm.ppf(1 - (1 - conf_level) / 2.0) * se
    z = np.arctanh(r)
    return np.tanh(z - moe), np.tanh(z + moe)


def _rho_rxy_rxz(rxy, rxz, ryz):
    num = (ryz - 0.5 * rxy * rxz) * (1 - rxy**2 - rxz**2 - ryz**2) + ryz**3
    den = (1 - rxy**2) * (1 - rxz**2)
    return num / den


def dependent_corr(xy, xz, yz, n, twotailed: bool = True,
                   conf_level: float = 0.95, method: str = "steiger"):
    """Significance of the difference between two dependent correlations
    r(x,y) and r(x,z) that share variable x, given r(y,z) and sample size n.

    method='steiger' -> (t, p); method='zou' -> (lower, upper) CI of the
    difference.  Vectorized over genes.
    """
    xy = np.asarray(xy, dtype=np.float64)
    xz = np.asarray(xz, dtype=np.float64)
    yz = np.asarray(yz, dtype=np.float64)
    if method == "steiger":
        d = xy - xz
        determin = 1 - xy**2 - xz**2 - yz**2 + 2 * xy * xz * yz
        av = (xy + xz) / 2
        cube = (1 - yz) ** 3
        denom = (2 * (n - 1) / (n - 3)) * determin + av**2 * cube
        with np.errstate(invalid="ignore", divide="ignore"):
            t2 = d * np.sqrt((n - 1) * (1 + yz) / denom)
        p = 1 - t_dist.cdf(np.abs(t2), n - 3)
        if twotailed:
            p = p * 2
        return t2, p
    if method == "zou":
        L1, U1 = fisher_z_ci(xy, n, conf_level)
        L2, U2 = fisher_z_ci(xz, n, conf_level)
        rho = _rho_rxy_rxz(xy, xz, yz)
        lower = xy - xz - np.sqrt((xy - L1) ** 2 + (U2 - xz) ** 2
                                  - 2 * rho * (xy - L1) * (U2 - xz))
        upper = xy - xz + np.sqrt((U1 - xy) ** 2 + (xz - L2) ** 2
                                  - 2 * rho * (U1 - xy) * (xz - L2))
        return lower, upper
    raise ValueError("method must be 'steiger' or 'zou'")


def independent_corr(xy, ab, n, n2=None, twotailed: bool = True,
                     conf_level: float = 0.95, method: str = "fisher"):
    """Significance of the difference between two independent correlations."""
    xy = np.asarray(xy, dtype=np.float64)
    ab = np.asarray(ab, dtype=np.float64)
    if n2 is None:
        n2 = n
    if method == "fisher":
        z = np.abs(np.arctanh(xy) - np.arctanh(ab)) / np.sqrt(
            1.0 / (n - 3) + 1.0 / (n2 - 3))
        p = 1 - norm.cdf(z)
        if twotailed:
            p = p * 2
        return z, p
    if method == "zou":
        L1, U1 = fisher_z_ci(xy, n, conf_level)
        L2, U2 = fisher_z_ci(ab, n2, conf_level)
        lower = xy - ab - np.sqrt((xy - L1) ** 2 + (U2 - ab) ** 2)
        upper = xy - ab + np.sqrt((U1 - xy) ** 2 + (ab - L2) ** 2)
        return lower, upper
    raise ValueError("method must be 'fisher' or 'zou'")
