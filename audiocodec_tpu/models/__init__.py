"""Neural model families built on the differentiable codec.

The reference's stated purpose is slotting its differentiable MDCT +
psychoacoustic graphs into neural audio pipelines (its transforms are
batched @tf.function graphs and its noise injection exists to simulate
quantization differentiably — audiocodec/psychoacoustic.py:151-167). The
reference ships no models; this package provides the canonical ones for
the framework, accelerator-first: pure-pytree parameters, GEMM-shaped matmuls,
mesh-sharded training steps.
"""

from audiocodec_tpu.models import post_filter, rvq  # noqa: F401
from audiocodec_tpu.models.spectral_ae import (  # noqa: F401
    SpectralAE,
    init_params,
    make_train_step,
    perceptual_loss,
)
from audiocodec_tpu.models.post_filter import PostFilter  # noqa: F401
