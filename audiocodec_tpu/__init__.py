"""audiocodec_tpu — a JAX/XLA perceptual audio codec framework.

Capability parity with korneelvdbroek/audiocodec (MDCT filter bank +
psychoacoustic masking model), redesigned for accelerators. See SURVEY.md for the
structural analysis of the reference and README.md for the design.
"""

from audiocodec_tpu.codec import Codec, EncodedFrames
from audiocodec_tpu.mdct import MDCT
from audiocodec_tpu.psycho import PsychoacousticModel
from audiocodec_tpu.resample import Resampler
from audiocodec_tpu import lossless
from audiocodec_tpu import metrics
from audiocodec_tpu import nf
from audiocodec_tpu import quantize
from audiocodec_tpu import tns

__version__ = "0.3.0"  # keep in sync with pyproject.toml

__all__ = [
    "Codec", "EncodedFrames", "MDCT", "PsychoacousticModel", "Resampler",
    "lossless", "metrics", "nf", "quantize", "tns",
    "__version__",
]
