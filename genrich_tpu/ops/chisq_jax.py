"""Device Fisher combination: chi-squared upper tail, jittable.

Ports of the R-3.5.0-derived pgamma family (engine/chisq.py documents
the host versions; Genrich.c:403-667) as jnp programs with
fixed-point lax.while_loops — the per-element series run until every
lane converges (masked updates preserve each lane's own stopping
point).  Float64 on CPU matches the exact engine; float32 is the
device fast path.

fisher_combine() assumes replicate p-value arrays share interval
boundaries — in the tile model all replicates' events go through one
sort, so their values are aligned by construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_M_LN2 = 0.693147180559945309417232121458176568
_M_LN10 = 2.302585092994045684017991454684364208
_M_LOG10E = 0.434294481903251827651128918916605082
_SFERR = np.array([
    0.0, 0.0810614667953272582196702, 0.0413406959554092940938221,
    0.02767792568499833914878929, 0.02079067210376509311152277,
    0.01664469118982119216319487, 0.01387612882307074799874573,
    0.01189670994589177009505572, 0.010411265261972096497478567,
    0.009255462182712732917728637, 0.008330563433362871256469318,
    0.007573675487951840794972024, 0.006942840107209529865664152,
    0.006408994188004207068439631, 0.005951370112758847735624416,
    0.005554733551962801371038690])
_S = (1 / 12., 1 / 360., 1 / 1260., 1 / 1680., 1 / 1188.)


def _log1_exp(x):
    return jnp.where(x > -_M_LN2, jnp.log(-jnp.expm1(x)),
                     jnp.log1p(-jnp.exp(x)))


def _bd0(x, np_):
    dt = x.dtype
    eps = jnp.finfo(dt).tiny
    fallback = x * jnp.log(x / np_) + np_ - x
    near = jnp.abs(x - np_) < 0.1 * (x + np_)
    v = jnp.where(near, (x - np_) / (x + np_), 0.0)
    s0 = (x - np_) * v
    tiny = jnp.abs(s0) < eps
    v2 = v * v

    def cond(st):
        j, ej, s, active = st
        return jnp.any(active) & (j < 1000)

    def body(st):
        j, ej, s, active = st
        ej = jnp.where(active, ej * v2, ej)
        s1 = jnp.where(active, s + ej / (2 * j + 1), s)
        active = active & (s1 != s)
        return j + 1, ej, jnp.where(active | (s1 == s), s1, s), active

    _, _, series, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(1), 2 * x * v, s0, near & ~tiny))
    return jnp.where(near, jnp.where(tiny, s0, series), fallback)


def _stirlerr(n):
    nn = n * n
    big = (_S[0] - (_S[1] - _S[2] / nn) / nn) / n
    mid = (_S[0] - (_S[1] - (_S[2] - _S[3] / nn) / nn) / nn) / n
    small = (_S[0] - (_S[1] - (_S[2] - (_S[3] - _S[4] / nn) / nn)
                      / nn) / nn) / n
    tab = jnp.asarray(_SFERR, n.dtype)[
        jnp.clip(n.astype(jnp.int32), 0, 15)]
    return jnp.where(n > 80.0, big,
                     jnp.where(n > 35.0, mid,
                               jnp.where(n > 15.0, small, tab)))


def _dpois(x, lam):
    return (-0.5 * jnp.log(2.0 * jnp.pi * x) - _stirlerr(x)
            - _bd0(x, lam))


def _pd_upper_series(x, alph):
    dt = x.dtype
    eps = jnp.finfo(dt).eps

    def cond(st):
        a, term, total, active = st
        return jnp.any(active)

    def body(st):
        a, term, total, active = st
        a = jnp.where(active, a + 1, a)
        term = jnp.where(active, term * x / a, term)
        total = jnp.where(active, total + term, total)
        active = active & (term > total * eps)
        return a, term, total, active

    t0 = x / alph
    _, _, total, _ = jax.lax.while_loop(
        cond, body, (alph, t0, t0, x == x))
    return jnp.log(total)


def _pd_lower_series(lam, y):
    dt = lam.dtype
    eps = jnp.finfo(dt).eps

    def cond(st):
        y_, term, total, active = st
        return jnp.any(active)

    def body(st):
        y_, term, total, active = st
        term = jnp.where(active, term * y_ / lam, term)
        total = jnp.where(active, total + term, total)
        y_ = jnp.where(active, y_ - 1, y_)
        active = active & (y_ >= 1) & (term > total * eps)
        return y_, term, total, active

    _, _, total, _ = jax.lax.while_loop(
        cond, body, (y, jnp.ones_like(lam), jnp.zeros_like(lam),
                     y >= 1))
    return jnp.log1p(total)


def _pgamma_smallx(x, alph):
    dt = x.dtype
    eps = jnp.finfo(dt).eps

    def cond(st):
        n, c, total, active = st
        return jnp.any(active)

    def body(st):
        n, c, total, active = st
        n = jnp.where(active, n + 1, n)
        c = jnp.where(active, c * -x / n, c)
        term = jnp.where(active, c / (alph + n), 0.0)
        total = jnp.where(active, total + term, total)
        active = active & (jnp.abs(term) > eps * jnp.abs(total))
        return n, c, total, active

    # initial mask derived from x so its device-varying type matches
    # the loop-carried mask under shard_map (vma typing)
    _, _, total, _ = jax.lax.while_loop(
        cond, body, (jnp.zeros_like(x), alph + 0.0,
                     jnp.zeros_like(x), x == x))
    lf2 = alph * jnp.log(x) - jax.lax.lgamma(alph + 1)
    return _log1_exp(jnp.log1p(total) + lf2)


def pgamma(x, alph):
    """log upper-tail gamma CDF; alph integral in [2, 200]."""
    x = jnp.asarray(x)
    alph = jnp.broadcast_to(jnp.asarray(alph, x.dtype), x.shape)
    xs = jnp.maximum(x, jnp.asarray(1e-30, x.dtype))
    small = _pgamma_smallx(jnp.where(x < 1, xs, 0.5), alph)
    xm = jnp.where(x >= 1, xs, 2.0)
    up = _log1_exp(_pd_upper_series(xm, alph) + _dpois(alph - 1, xm))
    lo = _pd_lower_series(xm, alph - 1) + _dpois(alph - 1, xm)
    return jnp.where(x < 1, small,
                     jnp.where(x <= alph - 1, up, lo))


def pchisq_neglog10(x, df):
    """-log10 chi-squared upper tail (df even in [4, 400])."""
    x = jnp.asarray(x)
    return -pgamma(x / 2.0, jnp.asarray(df, x.dtype) / 2.0) / _M_LN10


def fisher_combine(pvals: jnp.ndarray, skip=jnp.nan) -> jnp.ndarray:
    """Combine aligned replicate -log10 p arrays [R, M] (multPval).

    Values equal to -1 (SKIP) are excluded per lane; df = 2 * live
    replicates.  Returns the combined -log10 p per interval (SKIP
    where no replicate has a value).
    """
    live = pvals != -1.0
    total = jnp.sum(jnp.where(live, pvals, 0.0), axis=0)
    df = 2 * jnp.sum(live, axis=0)
    comb = pchisq_neglog10(2.0 * total / _M_LOG10E, df)
    out = jnp.where(df == 2, total, comb)
    out = jnp.where((df > 2) & (total == 0), 0.0, out)
    out = jnp.where(df == 0, -1.0, out)
    return out
