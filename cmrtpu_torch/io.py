"""Medical-image I/O of the port — the shared ``cmrtpu.io`` codecs.

NIfTI and NRRD reading and writing, and the ``MedicalImage`` geometry, are
numpy-only host code; the port re-exports them rather than copying them, so
the files it reads and writes are those of ``cmrtpu`` by construction.
Importing this module imports no JAX.
"""

from cmrtpu.io import MedicalImage, read_image, write_image

__all__ = ["MedicalImage", "read_image", "write_image"]
