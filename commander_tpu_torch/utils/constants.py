"""Physical constants (SI) used across the sky/instrument model."""

H_PLANCK = 6.62607015e-34   # J s
K_BOLTZ = 1.380649e-23      # J / K
C_LIGHT = 2.99792458e8      # m / s
T_CMB = 2.7255              # K
GHZ = 1.0e9

# Prescaled ratio h/k [K s], computed in Python f64. ALWAYS use this (as
# `H_OVER_K * nu / T`) instead of `H_PLANCK * nu / (K_BOLTZ * T)` in code
# that can run in float32: XLA's constant-folder/algebraic simplifier may
# reassociate products like (h*nu/(k*T))^2 into (h*nu)^2/(k*T)^2, and
# (6.6e-34 * 3e10)^2 ~ 4e-46 underflows float32 to 0/0 = NaN. Observed as
# a compiled-mode-only NaN in lax.map/scan bodies on CPU XLA (jax 0.9.0)
# while the identical eager expression was finite.
H_OVER_K = H_PLANCK / K_BOLTZ
