"""2D oscillating beam with the Cauchy-stress integrator.

Counterpart of /root/reference/tests/2d_examples/
test_2d_oscillating_beam_cauchy/cauchy_oscillating_beam.cpp: identical
scene and constants to cases/oscillating_beam_2d.py, but the first-half
stress relaxation obtains PK1 from the Cauchy stress of the Almansi
strain (Integration1stHalfCauchy, elastic_dynamics.cpp:148-160) instead
of the PK2 constitutive form — for Saint-Venant-Kirchhoff at moderate
strain the two discretizations track each other closely.
"""

from __future__ import annotations

from functools import partial

from sphinxsys_jax.cases import oscillating_beam_2d as base

T0 = 1.0

build_case = partial(base.build_case, integrator="cauchy")
make_run_chunk = base.make_run_chunk
tip_displacement = base.tip_displacement
BeamSim = base.BeamSim
BeamCase = base.BeamCase
