"""Device kernels + parity oracles.

- backend: which path each stage takes on the platform it runs on
- rrc: per-column gain/bias (byte-exact C-double cast in double-word f32)
- phasecorr: cv::phaseCorrelate on jnp.fft, windowed fast peak
- resample: cubic upsample, parity remap, fast blocked-matmul remap
- polyfit: shift-model fitting
- cv_exact: numpy oracle for the OpenCV semantics the reference relies on
"""

from . import backend, cv_exact, phasecorr, polyfit, resample, rrc  # noqa: F401
