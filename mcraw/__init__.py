"""mcraw: a JAX framework for decoding MotionCam Pro .mcraw video.

A from-scratch JAX/XLA rebuild of the capabilities of the C++
motioncam-decoder reference (see SURVEY.md). Public surface mirrors the
reference Decoder API (Decoder.hpp:47-92) plus batched device decode.
"""

from .errors import (  # noqa: F401
    DecodeError,
    IOException,
    MetadataError,
    MotionCamException,
)
from .container import (  # noqa: F401
    ContainerReader,
    ItemType,
    COMPRESSION_TYPE,
    COMPRESSION_TYPE_LEGACY,
)
from .metadata import ContainerMetadata, FrameMetadata  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy: keep `import mcraw` JAX-free for pure-container use cases.
    if name == "Decoder":
        from .pipeline import Decoder

        return Decoder
    if name in ("decode_modern", "decode_legacy"):
        # NumPy reference codecs — the direct analogues of raw::Decode /
        # raw::DecodeLegacy (RawData.hpp:25-37).
        from .kernels import numpy_ref

        return getattr(numpy_ref, name)
    raise AttributeError(name)
