"""Multi-device scale-out: meshes, sharded corpus encode, training step.

The reference is single-process TF with no distribution machinery at all
(SURVEY.md §2.2); this subsystem is the scale story: GSPMD
shardings over a jax.sharding.Mesh, with XLA inserting the collectives.
"""

from audiocodec_tpu.parallel.mesh import (
    make_mesh,
    spectrum_sharding,
    waveform_sharding,
)
from audiocodec_tpu.parallel.corpus import encode_corpus, make_corpus_encoder

__all__ = [
    "make_mesh",
    "waveform_sharding",
    "spectrum_sharding",
    "encode_corpus",
    "make_corpus_encoder",
]
