"""opticalimageprocessor_tpu — optical satellite image pre-processing
framework on JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
``arloan/OpticalImageProcessor`` (dual-CMOS push-broom PAN/MSS pipelines:
downlink aux separation, relative radiometric correction, phase-correlation
registration, cubic-resampling band alignment, CMOS stitching), built as
whole-scene device programs: line-axis sharding over device meshes with
halo exchange, and a streaming host runtime.
"""

__version__ = "0.1.0"
