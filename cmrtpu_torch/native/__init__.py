"""Native (C++) host-runtime components.

``cmrio`` is the byte-level IO core (gzip inflate/deflate, whole-file reads,
parallel batch inflate) — the rebuild's equivalent of the reference's
SimpleITK C++ IO core (ref: src/data/Dataset.py:163-250). It is compiled
on first import with the system toolchain and cached in ``_build/``;
every consumer must keep working when the toolchain is unavailable
(pure-Python zlib fallback in cmrtpu_torch/io/). A copy of ``cmrtpu/native``
whose library builds into ``cmrtpu_torch/_build/``.
"""

from cmrtpu_torch.native.build import get_library, native_available  # noqa: F401
from cmrtpu_torch.native.cmrio import (  # noqa: F401
    inflate,
    deflate_gzip,
    read_file_bytes,
    inflate_batch,
)
