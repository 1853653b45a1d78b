"""Various laser wavelengths, units of um (counterpart of ``prysm_tpu/wavelengths.py``)."""

# IR
CO2 = 10.6
NdYAP = 1.080
NdYAG = 1.064
InGaAs = .980

# VIS
Ruby = .694
HeNe = .6328
Cu = .578

# UV / DUV / EUV / X-Ray
XeF = .351
XeCl = .308
KrF = .248
KrCl = .222
ArF = .193
