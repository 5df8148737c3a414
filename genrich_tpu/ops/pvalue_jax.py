"""Device -log10 p-values: log-normal null, jittable.

Port of calcPval/plnorm/pnorm (Genrich.c:1490-1653; R-3.5.0 rational
approximations) as a branch-free jnp program.  Dtype-parameterized:
float64 on CPU reproduces the reference to the ulp; float32 is the
device fast path (validated against the exact engine to ~1e-4 relative
in tests, ample for a -log10 score whose downstream use is
thresholding).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_A = [2.2352520354606839287, 161.02823106855587881,
      1067.6894854603709582, 18154.981253343561249,
      0.065682337918207449113]
_B = [47.20258190468824187, 976.09855173777669322,
      10260.932208618978205, 45507.789335026729956]
_C = [0.39894151208813466764, 8.8831497943883759412,
      93.506656132177855979, 597.27027639480026226,
      2494.5375852903726711, 6848.1904505362823326,
      11602.651437647350124, 9842.7148383839780218,
      1.0765576773720192317e-8]
_D = [22.266688044328115691, 235.38790178262499861,
      1519.377599407554805, 6485.558298266760755,
      18615.571640885098091, 34900.952721145977266,
      38912.003286093271411, 19685.429676859990727]
_P = [0.21589853405795699, 0.1274011611602473639,
      0.022235277870649807, 0.001421619193227893466,
      2.9112874951168792e-5, 0.02307344176494017303]
_Q = [1.28426009614491121, 0.468238212480865118,
      0.0659881378689285515, 0.00378239633202758244,
      7.29751555083966205e-5]

_M_LN10 = 2.302585092994045684017991454684364208
_LOGSQRT = 0.445999019652555
_SQRTLOG = 0.944456478248262
FLT_MAX = np.float32(3.4028234663852886e38)


def _do_del(y, temp, ret, dt):
    xsq = jnp.trunc(y * 16) / 16
    d = (y - xsq) * (y + xsq)
    lower = jnp.log1p(-jnp.exp((-xsq * xsq - d) / 2) * temp)
    upper = (-xsq * xsq - d) / 2 + jnp.log(temp)
    return jnp.where(ret, lower, upper)


def pnorm_upper_log(x: jnp.ndarray) -> jnp.ndarray:
    """log of the standard-normal upper tail (pnorm port)."""
    dt = x.dtype
    y = jnp.abs(x)
    eps = jnp.finfo(dt).eps

    # small |x|
    xsq = x * x
    xnum = jnp.asarray(_A[4], dt) * xsq
    xden = xsq
    for i in range(3):
        xnum = (xnum + jnp.asarray(_A[i], dt)) * xsq
        xden = (xden + jnp.asarray(_B[i], dt)) * xsq
    t_small = x * (xnum + jnp.asarray(_A[3], dt)) \
        / (xden + jnp.asarray(_B[3], dt))
    t_tiny = x * jnp.asarray(_A[3] / _B[3], dt)
    t1 = jnp.where(y > eps * 0.5, t_small, t_tiny)
    r_small = jnp.log(jnp.asarray(0.5, dt) - t1)

    # mid |x|
    xnum = jnp.asarray(_C[8], dt) * y
    xden = y
    for i in range(7):
        xnum = (xnum + jnp.asarray(_C[i], dt)) * y
        xden = (xden + jnp.asarray(_D[i], dt)) * y
    t2 = (xnum + jnp.asarray(_C[7], dt)) / (xden + jnp.asarray(_D[7], dt))
    r_mid = _do_del(y, t2, x <= 0, dt)

    # large |x|
    inv = 1.0 / jnp.maximum(x * x, jnp.asarray(1e-30, dt))
    xnum = jnp.asarray(_P[5], dt) * inv
    xden = inv
    for i in range(4):
        xnum = (xnum + jnp.asarray(_P[i], dt)) * inv
        xden = (xden + jnp.asarray(_Q[i], dt)) * inv
    t3 = inv * (xnum + jnp.asarray(_P[4], dt)) \
        / (xden + jnp.asarray(_Q[4], dt))
    t3 = (jnp.asarray(1.0 / np.sqrt(2 * np.pi), dt) - t3) \
        / jnp.maximum(y, jnp.asarray(1e-30, dt))
    r_large = _do_del(x, t3, x <= 0, dt)

    sqrt32 = jnp.asarray(np.sqrt(32.0), dt)
    huge = jnp.asarray(1e170 if dt == jnp.float64
                       else np.finfo(np.float32).max, dt)
    out = jnp.where(y <= 0.67448975, r_small,
                    jnp.where(y <= sqrt32, r_mid,
                              jnp.where(y < huge, r_large,
                                        jnp.asarray(-0.0, dt))))
    return out


def calc_pval(expt: jnp.ndarray, ctrl: jnp.ndarray) -> jnp.ndarray:
    """-log10 p per interval (calcPval port); ctrl==SKIP -> SKIP."""
    dt = expt.dtype
    mu = ctrl.astype(dt)
    mu_safe = jnp.maximum(mu, jnp.asarray(1e-30, dt))
    big = mu > 7.0
    sd = 10.0 * jnp.log10(mu_safe)
    mu2 = mu_safe * mu_safe
    sd2 = sd * sd
    meanlog = jnp.where(big, jnp.log(mu2 / jnp.sqrt(sd2 + mu2)),
                        jnp.log(mu_safe) - jnp.asarray(_LOGSQRT, dt))
    sdlog = jnp.where(big, jnp.sqrt(jnp.log1p(sd2 / mu2)),
                      jnp.asarray(_SQRTLOG, dt))
    x = (jnp.log(jnp.maximum(expt, jnp.asarray(1e-30, dt))) - meanlog) \
        / sdlog
    pval = -pnorm_upper_log(x) / jnp.asarray(_M_LN10, dt)
    pval = jnp.minimum(pval, jnp.asarray(FLT_MAX, dt))
    zero = jnp.asarray(0.0, dt)
    pval = jnp.where(expt == 0, zero, pval)
    pval = jnp.where(ctrl == 0,
                     jnp.where(expt == 0, zero,
                               jnp.asarray(FLT_MAX, dt)), pval)
    pval = jnp.where(ctrl == jnp.asarray(-1.0, dt),
                     jnp.asarray(-1.0, dt), pval)
    return pval
