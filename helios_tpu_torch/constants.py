"""Physical constants in cgs units.

Values match the reference exactly (reference: source/kernels.cu:35-41 and
source/phys_const.py:27-44, which takes them from astropy) so that parity
tests against the reference equations agree to machine precision.
"""

PI = 3.141592653589793

# Planck constant [erg s]
H = 6.62607004e-27
# speed of light [cm s^-1]
C = 29979245800.0
# Boltzmann constant [erg K^-1]
K_B = 1.38064852e-16
# Stefan-Boltzmann constant [erg cm^-2 s^-1 K^-4]
# (reference kernels.cu:40: "yes, it needs to have this exact value to be
# consistent with astropy")
SIGMA_SB = 5.6703669999999995e-5
# atomic mass unit [g]
AMU = 1.6605390666e-24
# universal gas constant [erg K^-1 mol^-1]
R_UNIV = 83144626.1815324
# gravitational constant
G_GRAV = 6.6743e-8

# astronomical unit [cm]
AU = 14959787070000.0
# Jupiter radius [cm]
R_JUP = 7149200000.0
# Jupiter mass [g]
M_JUP = 1.8981245973360505e30
# solar radius [cm]
R_SUN = 69570000000.0
# solar mass [g]
M_SUN = 1.988409870698051e33
# Earth radius [cm]
R_EARTH = 637810000.0
# Earth mass [g]
M_EARTH = 5.972167867791379e27
# Avogadro's number [mol^-1]
N_A = 6.02214076e23
# electron mass [g]
M_E = 9.1093837015e-28
# electron charge [Fr]
Q_E = 4.80320471257e-10
# Thomson scattering cross-section [cm^2]
SIGMA_T = 6.6524587321e-25
