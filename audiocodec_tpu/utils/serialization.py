"""Checkpoint / serialization for codec pytrees and streaming state.

All codec state is a deterministic precompute from constructor arguments
(same property as the reference — SURVEY.md §5 "checkpointing = re-running
the constructor"), so a checkpoint is just the constructor arguments; the
arrays rebuild bit-identically. Streaming state is one carry block per
direction plus a block offset (streaming.py), captured verbatim.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from audiocodec_tpu.codec import Codec

_DTYPE_NAMES = {"float32": jnp.float32, "float64": jnp.float64,
                "bfloat16": jnp.bfloat16}
_RETIRED_KEYS = ("use_pallas", "pallas_kernel")


def codec_config(codec: Codec) -> dict:
    """The constructor arguments that fully determine a codec."""
    return {
        "sample_rate": codec.psycho.sample_rate,
        "filters_n": codec.mdct.filters_n,
        "bark_bands_n": codec.psycho.bark_bands_n,
        "alpha": codec.psycho.alpha,
        "window_type": codec.mdct.window_type,
        "compute_dtype": str(jnp.dtype(codec.mdct.compute_dtype)),
        "fast_bf16": codec.mdct.fast_bf16,
        "dct_precision": codec.mdct.dct_precision,
        "bark_precision": codec.psycho.bark_precision,
        "sidecar_grid": codec.sidecar_grid,
    }


def save_codec(path: str, codec: Codec) -> None:
    with open(path, "w") as f:
        json.dump(codec_config(codec), f, indent=2)


def load_codec(path: str) -> Codec:
    with open(path) as f:
        cfg = json.load(f)
    dtype = _DTYPE_NAMES[cfg.pop("compute_dtype")]
    cfg.setdefault("dct_precision", "highest")  # older checkpoints
    # Configs saved before bark_precision existed were written by codecs
    # that ALWAYS ran the Bark matmuls at HIGHEST regardless of
    # dct_precision; defaulting to None (follow dct_precision) would
    # rebuild a codec with different thresholds/step sizes than the one
    # that wrote the checkpoint and corrupt decode of its bitstreams.
    cfg.setdefault("bark_precision", "highest")
    # Configs saved before sidecar quantization existed were written by
    # codecs that shipped raw-bfloat16 sidecars; defaulting to the new
    # grid would rebuild an encoder whose sidecars (and therefore step
    # sizes) differ from every bitstream the checkpoint already produced.
    cfg.setdefault("sidecar_grid", 0)
    # Older checkpoints also carry the transform-kernel choices of a
    # since-removed kernel layer ("use_pallas", "pallas_kernel"). They
    # never affected quantization (step sizes derive from thresholds and
    # sidecars, not from the transform's lowering), so they are dropped.
    for key in _RETIRED_KEYS:
        cfg.pop(key, None)
    return Codec.create(compute_dtype=dtype, **cfg)


def save_pytree(path: str, tree) -> None:
    """Persist an arbitrary pytree of arrays (model params, RVQ state,
    optax optimizer state) as a flat .npz — leaves in tree order.

    bfloat16 leaves ride as uint16 bit patterns (npz has no bf16); the
    original dtype name is recorded per leaf and restored exactly. The
    STRUCTURE is deliberately not serialized — load_pytree rebuilds into
    a caller-supplied template (e.g. ``init_params(...)`` /
    ``opt.init(params)``), which keeps loading pickle-free and safe on
    untrusted files.
    """
    leaves = jax.tree_util.tree_leaves(tree)
    payload = {"count": np.asarray([len(leaves)], dtype=np.int64)}
    for i, leaf in enumerate(leaves):
        arr = np.asarray(leaf)
        payload[f"dtype_{i}"] = np.frombuffer(
            str(arr.dtype).encode(), dtype=np.uint8
        )
        if arr.dtype == jnp.bfloat16:
            arr = arr.view(np.uint16)
        payload[f"leaf_{i}"] = arr
    np.savez(path, **payload)


def load_pytree(path: str, template):
    """Rebuild a pytree saved by :func:`save_pytree` into ``template``'s
    structure (leaf count must match; shapes/dtypes come from the file).

    :raises ValueError: when the file's leaf count does not match the
        template — the signature of loading a checkpoint from a different
        architecture config.
    """
    import ml_dtypes

    t_leaves, treedef = jax.tree_util.tree_flatten(template)
    with np.load(path) as z:
        n = int(z["count"][0])
        if n != len(t_leaves):
            raise ValueError(
                f"checkpoint has {n} leaves but the template has "
                f"{len(t_leaves)} — wrong architecture config for this "
                "checkpoint"
            )
        leaves = []
        for i in range(n):
            name = bytes(z[f"dtype_{i}"]).decode()
            arr = z[f"leaf_{i}"]
            if name == "bfloat16":
                arr = arr.view(ml_dtypes.bfloat16)
            leaves.append(jnp.asarray(arr))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def save_stream_state(path: str, enc_carry, dec_carry=None, offset=0) -> None:
    """Persist streaming carry state (see streaming.py: (carry, offset) is
    the entire resumable codec state at any chunk boundary)."""
    np.savez(
        path,
        enc_carry=np.asarray(enc_carry),
        dec_carry=(
            np.asarray(dec_carry)
            if dec_carry is not None
            else np.zeros(0, dtype=np.float32)
        ),
        offset=np.asarray([offset], dtype=np.int64),
    )


def load_stream_state(path: str):
    with np.load(path) as z:
        enc = jnp.asarray(z["enc_carry"])
        dec = jnp.asarray(z["dec_carry"]) if z["dec_carry"].size else None
        offset = int(z["offset"][0])
    return enc, dec, offset
