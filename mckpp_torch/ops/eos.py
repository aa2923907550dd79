"""UNESCO-1980 seawater state equations on torch tensors
(counterpart of ``mckpp_tpu/ops/eos.py``).

Reimplements the reference's EOS package (mckpp_physics_state_equations.F90)
from the published UNESCO-1980 / Millero / Lillibridge(1987) formulations:

* :func:`cpsw` — specific heat (Millero et al. 1973/1981 + Fofonoff 1980
  pressure polynomial).  Check value: 3849.500 J/(kg degC) at S=40, T=40 degC,
  P=10000 dbar (reference: mckpp_physics_state_equations.F90:24-25).
* :func:`abk80` — density anomaly (sigma, sigma0), thermal-expansion alpha,
  haline-contraction beta and compressibility kappa via algebraic derivatives
  of the 1980 equation of state (Lillibridge 1988).  Check values at
  S=35,T=15,P=0: alpha=2.14136e-4, beta=7.51638e-4, kappa=4.32576e-5; at
  S=40,T=0,P=10000: alpha=2.69822e-4, beta=6.88317e-4, kappa=3.55271e-5
  (reference: mckpp_physics_state_equations.F90:105-111).

Temperature is clamped at -2 degC as in the reference (:28-29, :142-144).
All functions are elementwise and broadcast over any array shape; the P=0
special cases are handled with ``torch.where`` so the functions stay
branch-free.  The CUDA kernels carry the same formulas as device
functions (``csrc/physics.cuh``).
"""

from __future__ import annotations

import torch


def cpsw(s, t1, p0):
    """Specific heat of seawater, J/(kg degC).

    s: salinity (IPSS-78); t1: temperature (degC); p0: pressure (dbar).
    """
    t = torch.clamp_min(t1, -2.0)
    p = p0 / 10.0
    sr = torch.sqrt(torch.abs(s))
    # cp0: P=0 term
    a = (-1.38385e-3 * t + 0.1072763) * t - 7.643575
    b = (5.148e-5 * t - 4.07718e-3) * t + 0.1770383
    cc = (((2.093236e-5 * t - 2.654387e-3) * t + 0.1412855) * t - 3.720283) * t + 4217.4
    cp0 = (b * sr + a) * s + cc
    # cp1: pressure terms at S=0
    a = (((1.7168e-8 * t + 2.0357e-6) * t - 3.13885e-4) * t + 1.45747e-2) * t - 0.49592
    b = (((2.2956e-11 * t - 4.0027e-9) * t + 2.87533e-7) * t - 1.08645e-5) * t + 2.4931e-4
    cc = ((6.136e-13 * t - 6.5637e-11) * t + 2.6380e-9) * t - 5.422e-8
    cp1 = ((cc * p + b) * p + a) * p
    # cp2: pressure terms for S > 0
    a = (((-2.9179e-10 * t + 2.5941e-8) * t + 9.802e-7) * t - 1.28315e-4) * t + 4.9247e-3
    b = (3.122e-8 * t - 1.517e-6) * t - 1.2331e-4
    a = (a + b * sr) * s
    b = ((1.8448e-11 * t - 2.3905e-9) * t + 1.17054e-7) * t - 2.9558e-6
    b = (b + 9.971e-8 * sr) * s
    cc = (3.513e-13 * t - 1.7682e-11) * t + 5.540e-10
    cc = (cc - 1.4300e-12 * t * sr) * s
    cp2 = ((cc * p + b) * p + a) * p
    return cp0 + cp1 + cp2


def abk80(s, t1, p):
    """Expansion coefficients & density of seawater (1980 EOS).

    Returns ``(alpha, beta, kappa, sig0, sig)`` with units
    degC^-1, (psu)^-1 *1e-3-scaled as in the reference, bar^-1, kg/m^3,
    kg/m^3.  ``p`` is pressure in dbar (>= 0).
    """
    t = torch.clamp_min(t1, -2.0)
    p0 = p / 10.0                       # bars
    sr = torch.sqrt(torch.abs(s))
    is_p0 = (p == 0.0)

    # ---- Sig80: sigma at atmospheric pressure --------------------------
    r1 = ((((6.536332e-9 * t - 1.120083e-6) * t + 1.001685e-4) * t
           - 9.095290e-3) * t + 6.793952e-2) * t - 0.157406
    r2 = (((5.3875e-9 * t - 8.2467e-7) * t + 7.6438e-5) * t - 4.0899e-3) * t + 8.24493e-1
    r3 = (-1.6546e-6 * t + 1.0227e-4) * t - 5.72466e-3
    r4 = 4.8314e-4
    sig0 = (r4 * s + r3 * sr + r2) * s + r1
    rho0 = 1000.0 + sig0

    # ---- Secant bulk modulus K -----------------------------------------
    b1 = (-5.3009e-4 * t + 1.6483e-2) * t + 7.944e-2
    a1 = ((-6.1670e-5 * t + 1.09987e-2) * t - 0.603459) * t + 54.6746
    kw = (((-5.155288e-5 * t + 1.360477e-2) * t - 2.327105) * t + 148.4206) * t + 19652.21
    k0 = (b1 * sr + a1) * s + kw
    e = (9.1697e-10 * t + 2.0816e-8) * t - 9.9348e-7
    bw = (5.2787e-8 * t - 6.12293e-6) * t + 8.50935e-5
    bb = bw + e * s
    d = 1.91075e-4
    cterm = (-1.6078e-6 * t - 1.0981e-5) * t + 2.2838e-3
    aw = ((-5.77905e-7 * t + 1.16092e-4) * t + 1.43713e-3) * t + 3.239908
    aa = (d * sr + cterm) * s + aw
    k = (bb * p0 + aa) * p0 + k0
    # guard the P=0 branch so PK stays finite there (result unused)
    pk = torch.where(is_p0, 0.0, p0 / k)
    sig_p = (1000.0 * pk + sig0) / (1.0 - pk)
    sig = torch.where(is_p0, sig0, sig_p)
    rho = 1000.0 + sig

    # ---- Beta (haline contraction) -------------------------------------
    sr5 = sr * 1.5
    drho = r2 + sr5 * r3 + (s + s) * r4
    dk0 = a1 + sr5 * b1
    da = cterm + sr5 * d
    db = e
    dk = (db * p0 + da) * p0 + dk0
    denom = (k - p0)
    abfac = torch.where(is_p0, 0.0, rho0 * p0 / (denom * denom))
    beta_p = (drho / (1.0 - pk) - abfac * dk) / rho
    beta = torch.where(is_p0, drho / rho, beta_p)

    # ---- Alpha (thermal expansion) -------------------------------------
    r1a = (((0.3268166e-7 * t - 0.4480332e-5) * t + 0.3005055e-3) * t
           - 0.1819058e-1) * t + 6.793952e-2
    r2a = ((0.215500e-7 * t - 0.247401e-5) * t + 0.152876e-3) * t - 4.0899e-3
    r3a = -0.33092e-5 * t + 1.0227e-4
    alph0 = (r3a * sr + r2a) * s + r1a
    b1a = -0.106018e-2 * t + 1.6483e-2
    a1a = (-0.18501e-3 * t + 0.219974e-1) * t - 0.603459
    kwa = ((-0.2062115e-3 * t + 0.4081431e-1) * t - 0.4654210e+1) * t + 148.4206
    k0a = (b1a * sr + a1a) * s + kwa
    ea = 0.183394e-8 * t + 2.0816e-8
    bwa = 0.105574e-6 * t - 6.12293e-6
    alphb = bwa + ea * s
    ca = -0.32156e-5 * t - 1.0981e-5
    awa = (-0.1733715e-5 * t + 0.232184e-3) * t + 1.43713e-3
    alphaa = ca * s + awa
    alphk = (alphb * p0 + alphaa) * p0 + k0a
    alpha_p = -(alph0 / (1.0 - pk) - abfac * alphk) / rho
    alpha = torch.where(is_p0, -alph0 / rho, alpha_p)

    # ---- Kappa (compressibility) ---------------------------------------
    delk = aa + (p0 + p0) * bb
    kappa_p = (1.0 - pk * delk) / denom
    kappa = torch.where(is_p0, 1.0 / k0, kappa_p)

    return alpha, beta, kappa, sig0, sig


def sig80(s, t1, p):
    """Density anomaly only (sigma0, sigma)."""
    _, _, _, sig0, sig = abk80(s, t1, p)
    return sig0, sig
