"""Command-line interface: encode / decode / roundtrip / info.

The reference ships no CLI, entry points or I/O (SURVEY.md §2.2); this is
the user-facing surface of the framework:

  python -m audiocodec_tpu encode  in.wav  out.acz  [--filters-n 1024] ...
  python -m audiocodec_tpu decode  out.acz rec.wav
  python -m audiocodec_tpu roundtrip in.wav rec.wav [--drown 0.2]
  python -m audiocodec_tpu info   out.acz
"""

from __future__ import annotations

import argparse
import os
import sys


def _build_codec(sample_rate, args, compute_dtype=None, bark_precision=None):
    import jax.numpy as jnp

    from audiocodec_tpu.codec import Codec

    if compute_dtype is None:
        compute_dtype = jnp.bfloat16 if args.bf16 else jnp.float32
    precision = getattr(args, "precision", "highest")
    return Codec.create(
        sample_rate=sample_rate,
        filters_n=args.filters_n,
        bark_bands_n=args.bark_bands_n,
        alpha=args.alpha,
        window_type=args.window if args.window != "none" else None,
        compute_dtype=compute_dtype,
        dct_precision=precision,
        # decode paths pass the container-recorded value: it is
        # step-size-critical (Bark sidecar expands through W_inv)
        bark_precision=bark_precision,
        # encoder-side: decode reconstructs the sidecar from the wire,
        # so decode paths never need the knob (default harmless there)
        sidecar_grid=getattr(args, "sidecar_grid", 4),
    )


def _dtype_from_meta(meta):
    """Map a container's recorded compute_dtype to the decode dtype.

    The bit-identical-step-size invariant (CLAUDE.md) requires decoding in
    the EXACT dtype the encoder derived thresholds in — silently
    downgrading float64 to float32 would change step sizes. float64
    containers additionally need x64 enabled before any trace.
    """
    import jax
    import jax.numpy as jnp

    name = meta["compute_dtype"]
    if name == "bfloat16":
        return jnp.bfloat16
    if name == "float32":
        return jnp.float32
    if name == "float64":
        jax.config.update("jax_enable_x64", True)
        return jnp.float64
    raise ValueError(
        f"container records unsupported compute_dtype {name!r}; "
        "expected one of bfloat16/float32/float64"
    )


def _read(path):
    from audiocodec_tpu import native

    return native.decode_wav(path)


def _maybe_resample(data, rate, target_rate, zeros=16):
    """Resample decoded float32 audio [B, samples, C] to ``target_rate``
    if it differs; no-op for 0/None/matching rates. Returns (data, rate)."""
    if not target_rate or target_rate == rate:
        return data, rate
    import jax.numpy as jnp
    import numpy as np

    from audiocodec_tpu.resample import Resampler

    r = Resampler.create(rate, target_rate, zeros=zeros)
    out = np.asarray(r.resample(jnp.asarray(data, jnp.float32)))
    return out, target_rate


def _maybe_normalize(wave, rate, target_lufs, recorded=None):
    """Gain the decoded audio to ``target_lufs`` integrated loudness
    (BS.1770), with a peak guard at -1 dBFS. 0/None = no-op. When the
    container recorded the source loudness (``--tag-loudness``), use it
    instead of re-measuring — one less pass, and it normalizes by the
    SOURCE loudness, unbiased by coding noise."""
    if not target_lufs:
        return wave
    import numpy as np

    from audiocodec_tpu import metrics

    measured = (
        float(recorded) if recorded is not None
        else metrics.loudness_lufs(wave, rate)
    )
    gain = 10.0 ** ((float(target_lufs) - measured) / 20.0)
    peak = float(np.abs(wave).max()) * gain
    limit = 10.0 ** (-1.0 / 20.0)
    if peak > limit:  # never clip: cap the gain at -1 dBFS true peak
        gain *= limit / peak
    print(f"loudness: {measured:.2f} LUFS -> target {target_lufs:.2f} "
          f"(gain {20*np.log10(gain):+.2f} dB)")
    return (wave * gain).astype(wave.dtype)


def _slice_window(wave, rate, start, duration):
    """Trim decoded audio to [start, start+duration) seconds.

    ``duration <= 0`` means "to the end". Raises SystemExit (a CLI usage
    error, not a crash) when ``start`` is at or past the end."""
    s0 = int(round(float(start or 0.0) * rate))
    if s0 >= wave.shape[1]:
        raise SystemExit(
            f"--start {start}s is at or past the end of the decoded "
            f"audio ({wave.shape[1] / rate:.3f}s)"
        )
    if duration and duration > 0:
        s1 = min(wave.shape[1], s0 + int(round(float(duration) * rate)))
    else:
        s1 = wave.shape[1]
    return wave[:, s0:s1]


def _trim_to_blocks(data, filters_n):
    samples = data.shape[1] - data.shape[1] % filters_n
    if samples == 0:
        raise ValueError(
            f"input has {data.shape[1]} samples but one MDCT block needs "
            f"{filters_n}; use a smaller --filters-n or a longer file"
        )
    return data[:, :samples]


def _pad_to_blocks(data, block):
    """Zero-pad the tail to a multiple of ``block`` samples instead of
    dropping it; returns (padded, original_samples). The container
    records the original count (``nsamp``) so decode trims back —
    round trips are length-exact (gapless)."""
    import numpy as np

    orig = data.shape[1]
    if orig == 0:
        raise ValueError("input has no samples")
    pad = (-orig) % block
    if pad:
        data = np.pad(data, ((0, 0), (0, pad), (0, 0)))
    return data, orig


def _refuse_lossy_flags(args, extra=()):
    """The lossy shaping ladder has no meaning when the output is exact;
    refuse rather than silently ignore a flag the user asked for."""
    for flag, attr in [
        ("--kbps", "kbps"), ("--cbr", "cbr"), ("--chunk-blocks", "chunk_blocks"),
        ("--ms", "ms"), ("--intensity", "intensity"), ("--dtx", "dtx"),
        ("--fec", "fec"), ("--preset", "preset"), ("--resample-to", "resample_to"),
        ("--bf16", "bf16"), ("--tns", "tns"), ("--nf", "nf"), ("--bwe", "bwe"),
        ("--tmask", "tmask"), ("--bs", "bs"), ("--tag-loudness", "tag_loudness"),
        ("--drown", "drown"), ("--reservoir", "reservoir"), *extra,
    ]:
        if getattr(args, attr, None):
            raise ValueError(
                f"--lossless is exact PCM coding; {flag} belongs to the "
                "lossy path and does not compose with it"
            )


def _cmd_encode_lossless(args):
    from audiocodec_tpu import lossless
    from audiocodec_tpu.io import wav as _wav

    _refuse_lossy_flags(args)
    x, rate, bits = _wav.read_wav_int(args.input)
    blob = lossless.encode_lossless(
        x, rate, bits=bits, level=getattr(args, "lossless_level", 1)
    )
    with open(args.output, "wb") as f:
        f.write(blob)
    raw = x.shape[0] * x.shape[1] * bits // 8
    print(
        f"{args.output}: lossless, {x.shape[0]} samples x {x.shape[1]} ch "
        f"{bits}-bit @ {rate} Hz, {len(blob)} bytes "
        f"({100.0 * len(blob) / raw:.1f}% of PCM)"
    )
    return 0


def _cmd_decode_lossless(args):
    from audiocodec_tpu import lossless
    from audiocodec_tpu.io import wav as _wav

    for flag, attr in [
        ("--resample-to", "resample_to"), ("--normalize-lufs", "normalize_lufs"),
        ("--bf16", "bf16"), ("--conceal", "conceal"),
    ]:
        if getattr(args, attr, None):
            raise ValueError(
                f"{flag} would modify samples; lossless decode writes the "
                "exact coded PCM (use the lossy tools on the decoded file)"
            )
    with open(args.input, "rb") as f:
        blob = f.read()
    # range-decode straight from the container: seekable streams (the
    # fidx index, or byte-addressable payloads) pay work proportional
    # to the requested window, not the archive length
    rate = lossless.describe(blob)["sample_rate"]
    start = int(round(getattr(args, "start", 0.0) * rate))
    dur = getattr(args, "duration", 0.0)
    count = int(round(dur * rate)) if dur else None
    if count is not None and count <= 0:
        raise ValueError(
            f"--duration {dur}s rounds to zero samples at {rate} Hz"
        )
    try:
        x, rate, bits = lossless.decode_lossless(
            blob, start=start, count=count
        )
    except ValueError as e:
        if start and "outside the stream" in str(e):
            raise ValueError(
                f"--start {args.start}s is at or past the end of the clip"
            ) from e
        raise
    _wav.write_wav_int(args.output, x, rate, bits)
    print(
        f"{args.output}: {x.shape[0]} samples x {x.shape[1]} ch "
        f"{bits}-bit @ {rate} Hz (exact)"
    )
    return 0


def cmd_encode(args):
    import jax.numpy as jnp

    from audiocodec_tpu.io import bitstream

    if getattr(args, "lossless", False):
        return _cmd_encode_lossless(args)
    data, rate = _read(args.input)
    data, rate = _maybe_resample(data, rate, args.resample_to)
    codec = _build_codec(rate, args)
    lufs = None
    if getattr(args, "tag_loudness", False):
        from audiocodec_tpu import metrics as _metrics

        lufs = round(float(_metrics.loudness_lufs(data, rate)), 2)
    # pad (not trim) so decode can reproduce the EXACT input length via
    # the container's nsamp field (gapless round trips)
    block = args.filters_n * (args.chunk_blocks or 1)
    data, orig_samples = _pad_to_blocks(data, block)
    x = jnp.asarray(data, dtype=codec.mdct.compute_dtype)
    if args.ms and x.shape[2] != 2:
        raise ValueError("--ms (joint mid/side) needs a stereo input")
    if getattr(args, "reservoir", 0.0) and not (
        args.kbps and getattr(args, "cbr", False) and args.chunk_blocks
    ):
        raise ValueError(
            "--reservoir needs --cbr (with --kbps and --chunk-blocks): "
            "it redistributes a constant-rate stream's per-chunk budget"
        )
    # "auto" defers to the rate-control heuristic when --kbps is given;
    # without a rate target there is nothing to adapt to -> plain rounding
    dz = getattr(args, "deadzone", "auto")
    fixed_dz = 0.5 if dz == "auto" else float(dz)
    if getattr(args, "fec", 0.0) and not args.chunk_blocks:
        raise ValueError(
            "--fec needs --chunk-blocks (redundant copies ride the "
            ".acs stream's chunk framing)"
        )
    if getattr(args, "dtx", 0.0):
        if not args.chunk_blocks:
            raise ValueError(
                "--dtx needs --chunk-blocks (silent records are a "
                ".acs stream feature)"
            )
        if args.kbps or args.fec:
            raise ValueError(
                "--dtx is VBR-only: it does not compose with "
                "--kbps/--cbr rate control or --fec redundancy"
            )

    if args.chunk_blocks:
        from audiocodec_tpu.io import stream_container

        extra = ""
        if args.kbps and getattr(args, "cbr", False):
            n_chunks, scales, kbps = stream_container.encode_stream_cbr(
                codec, x, args.output,
                chunk_blocks=args.chunk_blocks,
                target_kbps=args.kbps, drown=args.drown, ms=args.ms,
                deadzone=dz, tns=args.tns, nf=args.nf, tmask=args.tmask,
                bs=args.bs, bwe=args.bwe, intensity=args.intensity,
                fec=args.fec, reservoir_kbits=args.reservoir,
                orig_samples=orig_samples, lufs=lufs,
            )
            extra = (
                f", {kbps:.0f} kbit/s CBR, scales "
                f"{min(scales):.2f}..{max(scales):.2f}"
            )
            if args.reservoir:
                extra += f", reservoir {args.reservoir:g} kbit"
        elif args.kbps:
            n_chunks, tscale, kbps = (
                stream_container.encode_stream_with_target_bitrate(
                    codec, x, args.output,
                    chunk_blocks=args.chunk_blocks,
                    target_kbps=args.kbps, drown=args.drown, ms=args.ms,
                    deadzone=dz, tns=args.tns, nf=args.nf,
                    tmask=args.tmask, bs=args.bs, bwe=args.bwe,
                    intensity=args.intensity, fec=args.fec,
                    orig_samples=orig_samples, lufs=lufs,
                )
            )
            extra = f", {kbps:.0f} kbit/s, scale {tscale:.2f}"
        else:
            n_chunks = stream_container.encode_stream(
                codec, x, args.output,
                chunk_blocks=args.chunk_blocks, drown=args.drown,
                ms=args.ms, deadzone=fixed_dz, tns=args.tns, nf=args.nf,
                tmask=args.tmask, bs=args.bs, bwe=args.bwe,
                intensity=args.intensity, fec=args.fec,
                dtx=getattr(args, "dtx", 0.0),
                orig_samples=orig_samples, lufs=lufs,
            )
        size = os.path.getsize(args.output)
        raw = orig_samples * x.shape[2] * 2
        print(
            f"{args.input}: {orig_samples} samples @ {rate} Hz -> "
            f"{args.output} "
            f"(.acs stream, {n_chunks} chunks, {size} bytes, "
            f"{raw / size:.1f}x smaller than 16-bit PCM{extra})"
        )
        return 0

    if args.kbps:
        from audiocodec_tpu import rate as _rate

        result = _rate.encode_with_target_bitrate(
            codec, x, args.kbps, drown=args.drown, ms=args.ms, deadzone=dz,
            tns=args.tns, nf=args.nf, tmask=args.tmask, bs=args.bs,
            bwe=args.bwe, intensity=args.intensity,
            orig_samples=orig_samples, lufs=lufs,
        )
        # the trial's packed bytes ARE the container — write them verbatim
        # so the measured kbps is exactly the on-disk file's
        with open(args.output, "wb") as f:
            f.write(result.packed)
        size = len(result.packed)
        raw = data.size * 2
        print(
            f"{args.input}: {data.shape[1]} samples @ {rate} Hz, "
            f"{data.shape[2]} ch -> {args.output} ({size} bytes, "
            f"{result.kbps:.0f} kbit/s, scale {result.threshold_scale:.2f})"
        )
        return 0

    enc = codec.encode_frames(
        codec.mdct.transform(x), args.drown, ms=args.ms,
        deadzone=fixed_dz, tns=args.tns, nf=args.nf, tmask=args.tmask,
        bs=args.bs, bwe=args.bwe, intensity=args.intensity,
    )
    from audiocodec_tpu import quantize as _quantize

    size = bitstream.save(
        args.output,
        enc.codes,
        enc.bark16,
        sample_rate=rate,
        filters_n=args.filters_n,
        bark_bands_n=args.bark_bands_n,
        alpha=args.alpha,
        window_type=args.window if args.window != "none" else None,
        compute_dtype=str(jnp.dtype(codec.mdct.compute_dtype)),
        ms=args.ms,
        bark_precision=codec.psycho.bark_precision,
        sidecar_grid=codec.sidecar_grid,
        dz_recon=(
            _quantize.dz_recon_offset(fixed_dz) if fixed_dz != 0.5 else 0.0
        ),
        tns_idx=enc.tns_idx,
        tns_band_start=codec.tns_band_start,
        nf_levels=enc.nf_levels,
        nf_band_start=codec.nf_band_start,
        bs_flags=enc.bs_flags,
        bwe_gains=enc.bwe_gains,
        bwe_start=codec.bwe_start if args.bwe else 0,
        is_gains=enc.is_gains,
        is_start=codec.is_start if args.intensity else 0,
        orig_samples=orig_samples,
        lufs=lufs,
    )
    raw = orig_samples * data.shape[2] * 2  # vs 16-bit PCM
    print(
        f"{args.input}: {orig_samples} samples @ {rate} Hz, "
        f"{data.shape[2]} ch -> {args.output} ({size} bytes, "
        f"{raw / size:.1f}x smaller than 16-bit PCM)"
    )
    return 0


def cmd_corpus_decode(args):
    """Bulk-decode a directory of .acz files to WAVs with batched,
    shape-bucketed device passes — the decode-side mirror of `corpus`.

    Containers are host-unpacked concurrently, grouped by everything
    that shapes or parameterizes the decode program (frame bucket,
    channels, ms, dead zone, dtype, member presence), padded to
    power-of-two frame buckets (pad frames decode to silence the trim
    discards — MDCT frame locality), and decoded as batches through ONE
    jitted program per group. Per-clip threshold scales ride a traced
    [B,1,1,1] vector, so rate-controlled corpora stay one program too.
    Noise-filled clips are the exception: the fill PRNG is keyed by
    batch position, so agreement with a solo decode forces them
    through single-clip batches (still bucket-cached programs).

    Bulk output matches a solo `decode` to float ulps (quantization
    STEP SIZES are bit-identical — the format obligation — but a
    differently-shaped XLA program may fuse the float synthesis
    differently, landing within one 16-bit LSB of the solo result)."""
    import functools
    import glob as _glob
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    import numpy as np

    from audiocodec_tpu import native
    from audiocodec_tpu.io import bitstream

    paths = sorted(_glob.glob(os.path.join(args.indir, "*.acz")))
    if not paths:
        raise ValueError(f"no .acz files under {args.indir}")
    os.makedirs(args.outdir, exist_ok=True)

    # lossless containers (corpus --lossless output) mix freely with
    # lossy ones in a directory; they decode host-side to exact PCM at
    # each file's own rate/depth, then the lossy pipeline below handles
    # the rest
    from audiocodec_tpu import lossless as _lossless
    from audiocodec_tpu.io import wav as _wavmod

    ll_paths = [p for p in paths if _lossless.is_lossless_file(p)]
    if ll_paths:
        def _dec_ll(p):
            with open(p, "rb") as f:
                x, rate, bits = _lossless.decode_lossless(f.read())
            base = os.path.splitext(os.path.basename(p))[0]
            _wavmod.write_wav_int(
                os.path.join(args.outdir, base + ".wav"), x, rate, bits
            )

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            list(ex.map(_dec_ll, ll_paths))
        print(f"{len(ll_paths)} lossless containers -> exact PCM wavs")
        skip = set(ll_paths)
        paths = [p for p in paths if p not in skip]
        if not paths:
            return 0

    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as ex:
        loaded = list(ex.map(bitstream.load, paths))

    ref = loaded[0][2]
    keys = ("sample_rate", "filters_n", "bark_bands_n", "alpha",
            "window_type", "compute_dtype", "bark_precision")
    for path, (_, _, meta) in zip(paths, loaded):
        if tuple(meta[k] for k in keys) != tuple(ref[k] for k in keys):
            raise ValueError(
                f"{path} was encoded with a different codec config than "
                f"{paths[0]}; decode mixed corpora separately"
            )
    codec = _codec_from_container_meta(args, ref)
    n = ref["filters_n"]
    sr = ref["sample_rate"]

    # batch-parallel over every device on the mesh, like the corpus
    # encoder: the decode batch shards over dp (GSPMD splits the whole
    # program; pow2 batch buckets always tile a pow2 dp axis)
    from audiocodec_tpu.parallel import mesh as _mesh

    mesh = _mesh.make_mesh()
    dp = mesh.shape["dp"]
    bsh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("dp"))

    import ml_dtypes

    def put(a):
        """ONE placement with the target sharding (never route host
        arrays through a default-device put + reshard: that moves the
        bytes twice). Batch axes that tile the mesh
        shard over dp (pow2 buckets tile pow2 meshes); under-mesh
        batches (e.g. single-clip nf batches) replicate."""
        if a is None:
            return None
        if a.shape[0] % dp == 0:
            return jax.device_put(a, bsh)
        return jax.device_put(a)

    def _next_pow2(v):
        return 1 << (int(v) - 1).bit_length()

    groups: dict = {}
    for idx, (codes, bark, meta) in enumerate(loaded):
        frames = codes.shape[1]
        ti = meta["tns_idx"]
        key = (
            _next_pow2(frames), codes.shape[-1], bool(meta["ms"]),
            float(meta["dz_recon"]),
            None if ti is None else ti.shape[2], meta["tns_band_start"],
            meta["nf_levels"] is not None, meta["nf_band_start"],
            int(meta["nf_seed"]), meta["bs_flags"] is not None,
            (meta["bwe_start"]
             if meta["bwe_gains"] is not None else 0),
            (meta["is_start"]
             if meta["is_gains"] is not None else 0),
        )
        groups.setdefault(key, []).append(idx)

    @functools.partial(
        jax.jit,
        static_argnames=("ms", "dzr", "tns_bs", "nf_bs", "bwe_start",
                         "is_start"),
    )
    def dec(c, codes, bark, tscale, ms, dzr, tns, tns_bs, nfl, nf_bs,
            nf_seed, bsw, bweg, bwe_start, isg=None, is_start=0):
        kw = dict(
            threshold_scale=tscale, dz_recon=dzr, tns_idx=tns,
            tns_band_start=tns_bs or None, nf_levels=nfl,
            nf_band_start=None if nfl is None else nf_bs,
            nf_seed=nf_seed, bs_flags=bsw,
            bwe_gains=bweg, bwe_start=bwe_start or None,
        )
        if ms:
            return c.decode_bitstream_ms(
                codes, bark, is_gains=isg,
                is_start=is_start or None, **kw
            )
        return c.decode_bitstream(codes, bark, **kw)

    def write_one(idx, wave_np, frames):
        meta = loaded[idx][2]
        out = wave_np[None, n:-n]
        out = out[:, : (frames - 1) * n]
        nsamp = meta.get("orig_samples", 0)
        if nsamp:
            out = out[:, :nsamp]
        stem = os.path.splitext(os.path.basename(paths[idx]))[0]
        native.write_wav(
            os.path.join(args.outdir, stem + ".wav"), out, sr
        )

    done = 0
    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as ex:
        jobs = []
        for key, idxs in groups.items():
            (bucket, ch, ms, dzr, tns_order, tns_bs, has_nf, nf_bs,
             nf_seed, has_bsw, bwe_start, is_start) = key
            has_tns = tns_order is not None
            # noise-filled clips: batch position keys the fill PRNG
            sub_batches = (
                [[i] for i in idxs] if has_nf
                else [idxs[j : j + args.batch]
                      for j in range(0, len(idxs), args.batch)]
            )
            for sub in sub_batches:
                # pow2-bucket the batch dim too (pad rows are zero
                # codes, never written out): residual sub-batch sizes
                # must not each compile their own XLA program
                b = 1 << (len(sub) - 1).bit_length()
                codes_b = np.zeros((b, bucket + 1, n, ch), np.int32)
                bark_ch = 1 if ms else ch
                bark_b = np.zeros(
                    (b, bucket + 1, ref["bark_bands_n"], bark_ch),
                    np.uint16,
                )
                ts = np.ones((b, 1, 1, 1), np.float64)
                tns_b = (np.zeros((b, bucket + 1, tns_order, ch),
                                   np.int8)
                         if has_tns else None)
                nfl_b = (np.zeros((b, bucket + 1, ch), np.uint8)
                         if has_nf else None)
                bsw_b = (np.zeros((b, bucket + 1), bool)
                         if has_bsw else None)
                bwe_b = None
                if bwe_start:
                    from audiocodec_tpu import bwe as _bwe_mod

                    bwe_b = np.zeros(
                        (b, bucket + 1,
                         _bwe_mod.n_groups(n, bwe_start), ch),
                        np.uint8,
                    )
                isg_b = None
                if is_start:
                    from audiocodec_tpu import intensity as _is_mod

                    isg_b = np.zeros(
                        (b, bucket + 1, _is_mod.n_groups(n, is_start)),
                        np.uint8,
                    )
                for j, idx in enumerate(sub):
                    codes, bark, meta = loaded[idx]
                    f = codes.shape[1]
                    codes_b[j, :f] = codes[0]
                    bark_b[j, :f] = np.asarray(bark).view(np.uint16)[0]
                    ts[j] = meta["threshold_scale"]
                    if has_tns:
                        tns_b[j, :f] = meta["tns_idx"][0]
                    if has_nf:
                        nfl_b[j, :f] = meta["nf_levels"][0]
                    if has_bsw:
                        bsw_b[j, :f] = meta["bs_flags"][0]
                    if bwe_start:
                        bwe_b[j, :f] = meta["bwe_gains"][0]
                    if is_start:
                        isg_b[j, :f] = meta["is_gains"][0]
                wave = dec(
                    codec, put(codes_b),
                    put(bark_b.view(ml_dtypes.bfloat16)),
                    put(ts.astype(codec.mdct.compute_dtype)),
                    ms, dzr, put(tns_b), tns_bs, put(nfl_b),
                    nf_bs, np.uint32(nf_seed), put(bsw_b),
                    put(bwe_b), bwe_start, put(isg_b), is_start,
                )
                wave_h = np.asarray(wave.astype(jnp.float32))
                for j, idx in enumerate(sub):
                    frames = loaded[idx][0].shape[1]
                    jobs.append(ex.submit(
                        write_one, idx, wave_h[j], frames
                    ))
        for job in jobs:
            job.result()
            done += 1
    print(
        f"{args.indir}: decoded {done}/{len(paths)} containers -> "
        f"{args.outdir} ({len(groups)} program groups)"
    )
    return 0


def cmd_serve(args):
    """Run the dynamic-batching codec server (serve.py) until killed."""
    import time as _time

    from audiocodec_tpu import serve as _serve

    codec = _build_codec(args.sample_rate, args)
    server = _serve.CodecServer(
        codec, args.sample_rate,
        host=args.host, port=args.port, unix_path=args.unix_socket,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
    ).start()
    where = args.unix_socket or f"{args.host}:{server.port}"
    print(
        f"serving {args.sample_rate} Hz / N={args.filters_n} codec on "
        f"{where} (max batch {args.max_batch}, "
        f"wait {args.max_wait_ms} ms); Ctrl-C to stop"
    )
    try:
        while True:
            _time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def cmd_eval(args):
    """Objective quality of a degraded wav vs its reference: SNR,
    segmental SNR, and noise-to-mask ratio through the codec's own
    psychoacoustic model (metrics.py)."""
    import json as _json

    import jax.numpy as jnp

    from audiocodec_tpu import metrics

    ref, rrate = _read(args.reference)
    deg, drate = _read(args.degraded)
    if rrate != drate:
        raise ValueError(
            f"sample rates differ ({rrate} vs {drate} Hz); bring them "
            "together first with the `resample` command"
        )
    if ref.shape[2] != deg.shape[2]:
        raise ValueError(
            f"channel counts differ ({ref.shape[2]} vs {deg.shape[2]})"
        )
    common = min(ref.shape[1], deg.shape[1])
    common -= common % args.filters_n
    if common == 0:
        raise ValueError(
            f"no overlapping audio of at least one MDCT block "
            f"({args.filters_n} samples)"
        )
    codec = _build_codec(rrate, args)
    dtype = codec.mdct.compute_dtype
    result = metrics.evaluate(
        codec,
        jnp.asarray(ref[:, :common], dtype=dtype),
        jnp.asarray(deg[:, :common], dtype=dtype),
    )
    result["samples"] = common
    result["sample_rate"] = rrate
    result["lufs_ref"] = round(
        metrics.loudness_lufs(ref[:, :common], rrate), 2
    )
    result["lufs_deg"] = round(
        metrics.loudness_lufs(deg[:, :common], rrate), 2
    )
    if args.json:
        print(_json.dumps(result))
    else:
        print(f"{args.degraded} vs {args.reference} "
              f"({common} samples @ {rrate} Hz):")
        print(f"  SNR:            {result['snr_db']:8.2f} dB")
        print(f"  segmental SNR:  {result['seg_snr_db']:8.2f} dB")
        print(f"  NMR:            {result['nmr_db']:8.2f} dB "
              f"(mean sq ratio {result['nmr']:.4f}; < 0 dB means the "
              "error mostly hides under the masking threshold)")
        print(f"  loudness:       {result['lufs_deg']:8.2f} LUFS "
              f"(reference {result['lufs_ref']:.2f}; BS.1770 integrated)")
    return 0


def cmd_resample(args):
    """Standalone polyphase sample-rate conversion, wav -> wav."""
    from audiocodec_tpu import native

    data, rate = _read(args.input)
    if rate == args.rate:
        print(f"{args.input} is already at {rate} Hz; copying")
    out, out_rate = _maybe_resample(data, rate, args.rate, zeros=args.zeros)
    native.write_wav(args.output, out, out_rate)
    print(
        f"{args.input}: {data.shape[1]} samples @ {rate} Hz -> "
        f"{args.output}: {out.shape[1]} samples @ {out_rate} Hz"
    )
    return 0


def _is_acs(path):
    with open(path, "rb") as f:
        return f.read(4) in (b"ACS1", b"ACS2", b"ACS3")


def _codec_from_container_meta(args, meta):
    """THE ONE place a decoding command rebuilds its codec from a
    container's recorded config — the bitstream records the encoder's
    compute dtype and Bark precision, and the decoder MUST match them
    so both sides derive identical quantization steps (CLAUDE.md
    invariant); duplicating this block risks the two decode commands
    drifting apart on a future step-size-critical field."""
    args.filters_n = meta["filters_n"]
    args.bark_bands_n = meta["bark_bands_n"]
    args.alpha = meta["alpha"]
    args.window = meta["window_type"] or "none"
    return _build_codec(
        meta["sample_rate"], args, _dtype_from_meta(meta),
        bark_precision=meta.get("bark_precision", "highest"),
    )


def cmd_decode(args):
    import jax.numpy as jnp
    import numpy as np

    from audiocodec_tpu import native
    from audiocodec_tpu.io import bitstream

    if _is_acs(args.input):
        return _decode_stream(args)
    from audiocodec_tpu import lossless as _lossless

    if _lossless.is_lossless_file(args.input):
        return _cmd_decode_lossless(args)

    codes, bark, meta = bitstream.load(args.input)
    codec = _codec_from_container_meta(args, meta)
    tscale = meta.get("threshold_scale", 1.0)
    dzr = meta.get("dz_recon", 0.0)
    tns_idx = meta.get("tns_idx")
    if tns_idx is not None:
        tns_idx = jnp.asarray(tns_idx)
    tns_bs = meta.get("tns_band_start") or None
    import numpy as _np

    nfl = meta.get("nf_levels")
    # honor the RECORDED band start verbatim (0 is a legal wire value —
    # `or None` would silently substitute the codec default); uint32 the
    # seed before any jit boundary (seeds in [2^31, 2^32) are legal but
    # overflow jit's Python-int argument parsing when x64 is off)
    nf_kwargs = dict(
        nf_levels=None if nfl is None else jnp.asarray(nfl),
        nf_band_start=(None if nfl is None
                       else int(meta.get("nf_band_start", 0))),
        nf_seed=_np.uint32(meta.get("nf_seed", 0)),
    )
    bsf = meta.get("bs_flags")
    nf_kwargs["bs_flags"] = None if bsf is None else jnp.asarray(bsf)
    bweg = meta.get("bwe_gains")
    nf_kwargs["bwe_gains"] = None if bweg is None else jnp.asarray(bweg)
    if bweg is not None:
        # honor the RECORDED crossover verbatim, like nf_band_start
        nf_kwargs["bwe_start"] = int(meta.get("bwe_start", 0))
    if meta.get("ms"):
        isg = meta.get("is_gains")
        if isg is not None:
            # honor the RECORDED crossover verbatim, like bwe_start
            nf_kwargs["is_gains"] = jnp.asarray(isg)
            nf_kwargs["is_start"] = int(meta.get("is_start", 0))
        wave = codec.decode_bitstream_ms(
            jnp.asarray(codes), jnp.asarray(bark, dtype=jnp.bfloat16),
            threshold_scale=tscale, dz_recon=dzr, tns_idx=tns_idx,
            tns_band_start=tns_bs, **nf_kwargs,
        )
    else:
        wave = codec.decode_bitstream(
            jnp.asarray(codes), jnp.asarray(bark, dtype=jnp.bfloat16),
            threshold_scale=tscale, dz_recon=dzr, tns_idx=tns_idx,
            tns_band_start=tns_bs, **nf_kwargs,
        )
    n = meta["filters_n"]
    wave = np.asarray(wave.astype(jnp.float32))[:, n:-n]
    nsamp = meta.get("orig_samples", 0)
    if nsamp:
        # gapless: trim the encoder's tail padding back off
        wave = wave[:, :nsamp]
    if getattr(args, "start", 0.0) or getattr(args, "duration", 0.0):
        wave = _slice_window(
            wave, meta["sample_rate"], args.start, args.duration
        )
    wave, out_rate = _maybe_resample(
        wave, meta["sample_rate"], args.resample_to
    )
    wave = _maybe_normalize(
        wave, out_rate, getattr(args, "normalize_lufs", 0.0),
        recorded=meta.get("lufs"),
    )
    native.write_wav(args.output, wave, out_rate)
    print(
        f"{args.input} -> {args.output}: {wave.shape[1]} samples @ "
        f"{out_rate} Hz, {wave.shape[2]} ch"
    )
    return 0


def cmd_roundtrip(args):
    import jax.numpy as jnp
    import numpy as np

    from audiocodec_tpu import native

    data, rate = _read(args.input)
    data, rate = _maybe_resample(data, rate, args.resample_to)
    codec = _build_codec(rate, args)
    data, orig_samples = _pad_to_blocks(data, args.filters_n)
    x = jnp.asarray(data, dtype=codec.mdct.compute_dtype)
    if args.ms and x.shape[2] != 2:
        raise ValueError("--ms (joint mid/side) needs a stereo input")
    if (args.tns or args.nf or args.tmask or args.bs or args.bwe
            or args.ms or args.intensity):
        enc = codec.encode_frames(
            codec.mdct.transform(x), args.drown, ms=args.ms,
            tns=args.tns, nf=args.nf, tmask=args.tmask, bs=args.bs,
            bwe=args.bwe, intensity=args.intensity,
        )
        kw = dict(tns_idx=enc.tns_idx, nf_levels=enc.nf_levels,
                  bs_flags=enc.bs_flags, bwe_gains=enc.bwe_gains)
        if args.ms:
            out = codec.decode_bitstream_ms(
                enc.codes, enc.bark16, is_gains=enc.is_gains, **kw
            )
        else:
            out = codec.decode_bitstream(enc.codes, enc.bark16, **kw)
    else:
        out = codec.round_trip_quantized(x, drown=args.drown)
    n = args.filters_n
    rec = np.asarray(out.astype(jnp.float32))[:, n:-n][:, :orig_samples]
    orig = np.asarray(data)[:, :orig_samples]
    noise = ((orig - rec) ** 2).sum()
    snr = 10 * np.log10((orig**2).sum() / max(noise, 1e-30))
    native.write_wav(args.output, rec, rate)
    print(f"{args.input} -> {args.output}: SNR {snr:.2f} dB")
    return 0


def _decode_stream(args):
    import jax.numpy as jnp
    import numpy as np

    from audiocodec_tpu import native
    from audiocodec_tpu.io import stream_container

    with stream_container.StreamReader(args.input) as r:
        meta = dict(r.meta)
    args.filters_n = meta["filters_n"]
    args.bark_bands_n = meta["bark_bands_n"]
    args.alpha = meta["alpha"]
    args.window = meta["window_type"] or "none"
    codec = _build_codec(
        meta["sample_rate"], args, _dtype_from_meta(meta),
        bark_precision=meta.get("bark_precision", "highest"),
    )
    n = meta["filters_n"]
    sr = meta["sample_rate"]
    # preallocate from the chunk headers so peak memory stays ~1x the
    # requested window (the point of the streaming container). Under
    # --conceal the headers are untrusted: unreadable or implausible
    # entries fall back to the stream's modal body size (what
    # decode_stream will actually synthesize) instead of letting one
    # flipped u32 size a petabyte buffer.
    conceal = getattr(args, "conceal", False)
    with stream_container.StreamReader(args.input) as r:
        ch = r.meta["channels"]
        if conceal:
            # mirror decode_stream's conceal geometry exactly: modal
            # body size for every body chunk, one flush frame — chunk
            # headers are unverifiable on their own, and a concealed
            # chunk is synthesized at the modal size regardless of what
            # its (possibly corrupt) header claims
            modal = stream_container.modal_body_blocks(r)
            cb = [modal] * (r.n_chunks - 1) + [1] if r.n_chunks else []
        else:
            cb = [r.chunk_blocks(i) for i in range(r.n_chunks)]
    total_blocks = sum(cb)
    total = (total_blocks - 1) * n  # decoded samples after the pad trim
    nsamp = int(meta.get("nsamp", 0))
    if nsamp:
        # gapless: the header records the exact pre-padding length
        total = min(total, nsamp)
    start = float(getattr(args, "start", 0.0) or 0.0)
    duration = float(getattr(args, "duration", 0.0) or 0.0)
    s0 = int(round(start * sr))
    if s0 >= total:
        raise SystemExit(
            f"--start {start}s is at or past the end of the stream "
            f"({total / sr:.3f}s)"
        )
    if duration > 0:
        s1 = min(total, s0 + int(round(duration * sr)))
    else:
        s1 = total
    # chunk i's samples land at [(prior_i - 1)*n, (prior_i - 1 + cb_i)*n)
    # in trimmed output coordinates (the container's first/last n samples
    # are the round-trip pad); seek to the chunk containing s0 — entering
    # mid-stream only decodes one extra chunk for the overlap-add carry
    start_chunk, prior_sc, prior = 0, 0, 0
    for i, blocks_i in enumerate(cb):
        if (prior - 1) * n <= s0:
            start_chunk, prior_sc = i, prior
        prior += blocks_i
    # zeros, not empty: with concealed/odd-sized chunks the yielded total
    # can fall short of the header-derived estimate, and the tail must be
    # silence, not uninitialized memory
    wave = np.zeros((1, s1 - s0, ch), dtype=np.float32)
    pos = (prior_sc - 1) * n
    for c in stream_container.decode_stream(
        codec, args.input, start_chunk=start_chunk, conceal=conceal,
    ):
        arr = np.asarray(c.astype(jnp.float32))
        lo, hi = max(pos, s0), min(pos + arr.shape[1], s1)
        if hi > lo:
            wave[:, lo - s0 : hi - s0] = arr[:, lo - pos : hi - pos]
        pos += arr.shape[1]
        if pos >= s1:
            break
    wave, out_rate = _maybe_resample(wave, sr, args.resample_to)
    wave = _maybe_normalize(
        wave, out_rate, getattr(args, "normalize_lufs", 0.0),
        recorded=meta.get("lufs"),
    )
    native.write_wav(args.output, wave, out_rate)
    window = f" [{s0 / sr:.3f}s..{s1 / sr:.3f}s]" if (s0 or s1 < total) else ""
    print(
        f"{args.input} -> {args.output}: {wave.shape[1]} samples @ "
        f"{out_rate} Hz, {wave.shape[2]} ch (stream{window})"
    )
    return 0


def _cmd_corpus_lossless(args, paths):
    """Bulk lossless archival: thread-pooled per-file encode. Unlike the
    lossy corpus path there is no uniform-rate requirement — each file
    keeps its own rate/depth — and no device batching to amortize: the
    mode is entropy-coder-bound (DESIGN.md §22), the coders release the
    GIL (ctypes + zlib), and encode_lossless buckets its device call's
    frame count to powers of two so varied lengths compile O(log n)
    programs, not one per file."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    from audiocodec_tpu import lossless
    from audiocodec_tpu.io import wav as _wav

    _refuse_lossy_flags(args, extra=[("--cache", "cache")])
    os.makedirs(args.outdir, exist_ok=True)

    def one(path):
        x, rate, bits = _wav.read_wav_int(path)
        blob = lossless.encode_lossless(
            x, rate, bits=bits, level=getattr(args, "lossless_level", 1)
        )
        base = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(args.outdir, base + ".acz"), "wb") as f:
            f.write(blob)
        return x.shape[0] / rate, x.size * bits // 8, len(blob)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        stats = list(ex.map(one, paths))
    dt = time.perf_counter() - t0
    audio_s = sum(s for s, _, _ in stats)
    raw = sum(r for _, r, _ in stats)
    out = sum(o for _, _, o in stats)
    print(
        f"{len(paths)} files lossless -> {args.outdir}: "
        f"{out} / {raw} bytes ({100.0 * out / max(raw, 1):.1f}% of PCM), "
        f"{audio_s:.1f} audio-s in {dt:.1f} s ({audio_s / dt:.0f} audio-s/s)"
    )
    return 0


def cmd_corpus(args):
    """Bulk-encode a directory of WAVs into per-clip .acz bitstreams:
    native thread-pool decode (straight to the int16 wire) -> prefetched
    H2D -> mesh-sharded batched encode -> thread-pooled packing. With
    --cache, the decoded corpus persists as a raw PCM .npy so repeat runs
    skip WAV parsing entirely (parallel/pipeline.build_corpus_cache)."""
    import functools
    import glob as _glob
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    import numpy as np

    from audiocodec_tpu import quantize as _cli_quantize
    from audiocodec_tpu.io import bitstream
    from audiocodec_tpu.parallel import mesh as _mesh
    from audiocodec_tpu.parallel.pipeline import (
        CachedCorpusLoader,
        PrefetchingCorpusLoader,
        build_corpus_cache,
        validate_corpus_cache,
    )

    # dedupe case-variant globs by normalized path: on case-insensitive
    # filesystems *.wav and *.WAV both match every file, which would
    # double-encode the whole corpus
    seen = set()
    paths = []
    for pat in ("*.wav", "*.WAV"):
        for p in _glob.glob(os.path.join(args.indir, pat)):
            key = os.path.normcase(os.path.abspath(p))
            if key not in seen:
                seen.add(key)
                paths.append(p)
    paths.sort()
    if not paths:
        raise ValueError(f"no .wav files under {args.indir}")
    if getattr(args, "lossless", False):
        if args.sample_rate:
            raise ValueError(
                "--sample-rate does not apply with --lossless: each "
                "file's own rate is preserved exactly"
            )
        return _cmd_corpus_lossless(args, paths)
    if not args.sample_rate:
        raise ValueError("--sample-rate is required for lossy corpus encode")
    if args.chunk_blocks:
        raise ValueError(
            "--chunk-blocks streams a single file to .acs; the corpus "
            "command writes per-clip .acz containers only"
        )
    if args.resample_to:
        raise ValueError(
            "--resample-to is a single-file option; preprocess the corpus "
            "with the `resample` command (the bulk loaders decode at the "
            "corpus's uniform --sample-rate)"
        )
    os.makedirs(args.outdir, exist_ok=True)

    codec = _build_codec(args.sample_rate, args)
    if args.ms and args.channels != 2:
        raise ValueError("--ms (joint mid/side) needs --channels 2")
    mesh = _mesh.make_mesh()
    wsh = _mesh.waveform_sharding(mesh)
    n = args.filters_n
    # batches must tile the mesh's dp axis: round the batch size up; the
    # loaders zero-pad a short final batch host-side (pad_batches) so
    # every yielded batch has one shape and shards evenly. The cache is
    # built over the REAL paths only — its identity hash must not depend
    # on --batch or the device count.
    dp = mesh.shape["dp"]
    batch = _mesh.pad_batch_to(args.batch, dp)

    from audiocodec_tpu.parallel.pipeline import _dequant_wire

    # the CLI's coded-path flags apply to corpus encodes too
    dz = getattr(args, "deadzone", "auto")
    fixed_dz = 0.5 if dz == "auto" else float(dz)
    tag_loudness = getattr(args, "tag_loudness", False)

    def batch_lufs(dev_batch):
        """Per-clip BS.1770 loudness of a wire batch, [B] float64 —
        one vectorized device pass (metrics.loudness_lufs_batch) over
        the SAME dequantized wave the encoder sees."""
        from audiocodec_tpu import metrics as _metrics

        x = _dequant_wire(dev_batch, jnp.dtype(jnp.float32))
        return np.round(
            _metrics.loudness_lufs_batch(x, args.sample_rate), 2
        )

    @functools.partial(
        jax.jit, static_argnames=("ms", "tns", "nf", "tmask", "bs",
                                  "bwe", "intensity")
    )
    def encode_batch(b, ms, tns, nf, tmask=0.0, bs=False, bwe=False,
                     intensity=False):
        # the ONE int16-wire dequant definition (pipeline._dequant_wire):
        # it is bit-critical, so the CLI must not carry its own copy
        x = _dequant_wire(b, jnp.dtype(codec.mdct.compute_dtype))
        usable = x.shape[1] - x.shape[1] % n
        frames = codec.mdct.transform(x[:, :usable])
        return codec.encode_frames(frames, args.drown, ms=ms,
                                   deadzone=fixed_dz, tns=tns, nf=nf,
                                   tmask=tmask, bs=bs, bwe=bwe,
                                   intensity=intensity)

    if args.cache:
        if not os.path.exists(args.cache):
            status = build_corpus_cache(
                paths, args.cache, clip_seconds=args.clip_seconds,
                sample_rate=args.sample_rate, channels=args.channels,
                batch_size=batch,
            )
            print(
                f"built PCM cache {args.cache} "
                f"({int((status == 0).sum())}/{len(paths)} clips ok)"
            )
        # a stale/mismatched cache must fail loudly, not pack one clip's
        # audio under another clip's name (the cache is positional)
        validate_corpus_cache(
            args.cache, paths, clip_seconds=args.clip_seconds,
            sample_rate=args.sample_rate, channels=args.channels,
        )
        loader = CachedCorpusLoader(
            args.cache, batch_size=batch, sharding=wsh, pad_batches=True
        )
    else:
        loader = PrefetchingCorpusLoader(
            paths, clip_seconds=args.clip_seconds,
            sample_rate=args.sample_rate, channels=args.channels,
            batch_size=batch, sharding=wsh, wire_dtype="int16",
            pad_batches=True,
        )

    meta = dict(
        sample_rate=args.sample_rate,
        filters_n=n,
        bark_bands_n=args.bark_bands_n,
        alpha=args.alpha,
        window_type=args.window if args.window != "none" else None,
        compute_dtype=str(jnp.dtype(codec.mdct.compute_dtype)),
        ms=args.ms,
        bark_precision=codec.psycho.bark_precision,
        sidecar_grid=codec.sidecar_grid,
        dz_recon=(
            _cli_quantize.dz_recon_offset(fixed_dz)
            if fixed_dz != 0.5 else 0.0
        ),
        tns_band_start=codec.tns_band_start,
        nf_band_start=codec.nf_band_start,
        bwe_start=codec.bwe_start if args.bwe else 0,
        is_start=codec.is_start if args.intensity else 0,
    )

    def _out_path(idx):
        stem = os.path.splitext(os.path.basename(paths[idx]))[0]
        return os.path.join(args.outdir, stem + ".acz")

    def pack_one(idx, enc, j, lufs_j=None):
        return bitstream.save(
            _out_path(idx), enc.codes[j : j + 1], enc.bark16[j : j + 1],
            tns_idx=(None if enc.tns_idx is None
                     else enc.tns_idx[j : j + 1]),
            nf_levels=(None if enc.nf_levels is None
                       else enc.nf_levels[j : j + 1]),
            bs_flags=(None if enc.bs_flags is None
                      else enc.bs_flags[j : j + 1]),
            bwe_gains=(None if enc.bwe_gains is None
                       else enc.bwe_gains[j : j + 1]),
            is_gains=(None if enc.is_gains is None
                      else enc.is_gains[j : j + 1]),
            lufs=lufs_j,
            **meta,
        )

    def write_packed(idx, data):
        with open(_out_path(idx), "wb") as f:
            f.write(data)
        return len(data)

    if args.kbps:
        from audiocodec_tpu import rate as _rate

    ok = failed = total_bytes = 0
    base = 0
    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as ex:
        for dev, status in loader:
            if args.kbps:
                # rate-controlled corpus: every clip of the batch converges
                # to its own threshold scale targeting --kbps (rate.py's
                # vmapped two-round search); the search's final packed
                # container IS the output file, so the written bytes are
                # exactly the measured-rate bytes
                x = _dequant_wire(dev, jnp.dtype(codec.mdct.compute_dtype))
                usable = x.shape[1] - x.shape[1] % n
                results = _rate.encode_with_target_bitrate_batch(
                    codec, x[:, :usable], args.kbps,
                    drown=args.drown, ms=args.ms, deadzone=dz,
                    tns=args.tns, nf=args.nf, tmask=args.tmask,
                    bs=args.bs, bwe=args.bwe, intensity=args.intensity,
                    lufs=batch_lufs(dev) if tag_loudness else None,
                )
                payload = [res.packed for res in results]
            else:
                enc_h = jax.device_get(
                    encode_batch(dev, args.ms, args.tns, args.nf,
                                 tmask=args.tmask, bs=args.bs,
                                 bwe=args.bwe, intensity=args.intensity)
                )
                payload = None
            lufs_b = batch_lufs(dev) if tag_loudness else None
            b_n = (len(payload) if payload is not None
                   else enc_h.codes.shape[0])
            jobs = []
            for j in range(b_n):
                idx = base + j
                if idx >= len(paths):
                    break
                if status[j] != 0:
                    failed += 1
                    print(
                        f"skip {paths[idx]}: decode error {int(status[j])}",
                        file=sys.stderr,
                    )
                    continue
                if payload is not None:
                    jobs.append(ex.submit(write_packed, idx, payload[j]))
                else:
                    jobs.append(ex.submit(
                        pack_one, idx, enc_h, j,
                        None if lufs_b is None else float(lufs_b[j]),
                    ))
            for f in jobs:
                total_bytes += f.result()
                ok += 1
            base += b_n
    seconds = ok * args.clip_seconds
    kbps = total_bytes * 8 / max(seconds, 1e-9) / 1000
    print(
        f"encoded {ok}/{len(paths)} clips -> {args.outdir} "
        f"({total_bytes} bytes, ~{kbps:.0f} kbit/s avg)"
        + (f"; {failed} failed" if failed else "")
    )
    return 0 if ok else 1


def cmd_info(args):
    from audiocodec_tpu.io import bitstream

    if _is_acs(args.input):
        from audiocodec_tpu.io import stream_container

        with stream_container.StreamReader(args.input) as r:
            meta, n_chunks = dict(r.meta), r.n_chunks
            blocks = sum(r.chunk_blocks(i) for i in range(n_chunks))
        size = os.path.getsize(args.input)
        seconds = blocks * meta["filters_n"] / meta["sample_rate"]
        kbps = size * 8 / max(seconds, 1e-9) / 1000
        print(f"{args.input} (.acs stream):")
        for k, v in meta.items():
            print(f"  {k}: {v}")
        print(f"  chunks: {n_chunks}  blocks: {blocks}  (~{seconds:.2f} s)")
        print(f"  size: {size} bytes  (~{kbps:.0f} kbit/s)")
        return 0

    from audiocodec_tpu import lossless as _lossless

    with open(args.input, "rb") as fh:
        blob = fh.read()
    if _lossless.is_lossless_bytes(blob):
        d = _lossless.describe(blob)
        seconds = d["n_samples"] / d["sample_rate"]
        raw = d["n_samples"] * d["channels"] * d["bits"] // 8
        print(f"{args.input} (lossless):")
        for k, v in d.items():
            print(f"  {k}: {v}")
        print(
            f"  size: {len(blob)} bytes (~{seconds:.2f} s, "
            f"{100.0 * len(blob) / raw:.1f}% of PCM)"
        )
        return 0

    codes, bark, meta = bitstream.load(args.input)
    size = os.path.getsize(args.input)
    blocks = codes.shape[1]
    seconds = blocks * meta["filters_n"] / meta["sample_rate"]
    kbps = size * 8 / max(seconds, 1e-9) / 1000
    tns_idx = meta.pop("tns_idx", None)
    if tns_idx is not None:
        import numpy as _np

        fired = int(_np.any(tns_idx != 0, axis=(2,)).sum())
        meta["tns"] = (
            f"order {tns_idx.shape[2]}, band_start "
            f"{meta.get('tns_band_start')}, filtered "
            f"{fired}/{tns_idx.shape[0] * tns_idx.shape[1] * tns_idx.shape[3]}"
            " frame-channels"
        )
    meta.pop("tns_band_start", None)
    nfl = meta.pop("nf_levels", None)
    if nfl is not None:
        import numpy as _np

        meta["nf"] = (
            f"band_start {meta.get('nf_band_start')}, seed "
            f"{meta.get('nf_seed')}, filled {int((_np.asarray(nfl) > 0).sum())}"
            f"/{nfl.size} frame-channels"
        )
    if meta.get("lufs") is None:
        meta.pop("lufs", None)  # untagged: don't print a None row
    bsf = meta.pop("bs_flags", None)
    if bsf is not None:
        import numpy as _np

        meta["bs"] = (
            f"factor {meta.get('bs_factor')}, switched "
            f"{int(_np.asarray(bsf).sum())}/{bsf.size} frames"
        )
    bweg = meta.pop("bwe_gains", None)
    if bweg is not None:
        import numpy as _np

        meta["bwe"] = (
            f"start bin {meta.get('bwe_start')}, replicated "
            f"{int((_np.asarray(bweg) > 0).sum())}/{bweg.size} "
            "frame-groups"
        )
    isg = meta.pop("is_gains", None)
    if isg is not None:
        import numpy as _np

        meta["intensity"] = (
            f"start bin {meta.get('is_start')}, panned "
            f"{int((_np.asarray(isg) > 0).sum())}/{isg.size} "
            "frame-groups"
        )
    meta.pop("bwe_start", None)
    meta.pop("is_start", None)
    meta.pop("bs_factor", None)
    meta.pop("nf_band_start", None)
    meta.pop("nf_seed", None)
    print(f"{args.input}:")
    for k, v in meta.items():
        print(f"  {k}: {v}")
    print(f"  blocks: {blocks}  (~{seconds:.2f} s)")
    print(f"  size: {size} bytes  (~{kbps:.0f} kbit/s)")
    return 0


_PRESETS = {
    # attr -> value; applied only where the user left the flag at its
    # argparse default, so explicit flags always win over the preset
    "archive": {},
    "music": {"deadzone": "auto", "tns": True, "bs": True},
    "low": {"deadzone": "auto", "tns": True, "bs": True, "nf": True,
            "tmask": 130.0, "bwe": True, "intensity": True},
}

_PRESET_DEFAULTS = {
    "deadzone": "auto", "tns": False, "bs": False, "nf": False,
    "tmask": 0.0, "bwe": False, "intensity": False,
}


def _apply_preset(args, parser) -> None:
    if getattr(args, "tag_loudness", False) and args.fn not in (
        cmd_encode, cmd_corpus
    ):
        raise SystemExit(
            "--tag-loudness only applies to commands that write "
            "containers (encode, corpus)"
        )
    preset = getattr(args, "preset", None)
    if not preset:
        return
    for attr, value in _PRESETS[preset].items():
        if not hasattr(args, attr):
            continue
        if attr == "intensity" and not getattr(args, "ms", False):
            # intensity requires the mid/side layout: the preset only
            # turns it on for --ms encodes (an explicit --intensity on
            # a mono input still fails loudly, as it should)
            continue
        if getattr(args, attr) == _PRESET_DEFAULTS[attr]:
            setattr(args, attr, value)


def main(argv=None) -> int:
    from audiocodec_tpu.utils import compile_cache

    compile_cache.enable()
    parser = argparse.ArgumentParser(
        prog="audiocodec_tpu",
        description="perceptual audio codec",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def add_model_args(p):
        p.add_argument("--filters-n", type=int, default=1024)
        p.add_argument("--bark-bands-n", type=int, default=64)
        p.add_argument("--alpha", type=float, default=0.6)
        p.add_argument(
            "--window", choices=["vorbis", "sine", "none"], default="vorbis"
        )
        p.add_argument("--drown", type=float, default=0.0)
        p.add_argument("--bf16", action="store_true")
        p.add_argument(
            "--sidecar-grid", type=int, default=4,
            choices=[0, 1, 2, 4, 8],
            help="levels per octave of the Bark sidecar's log grid "
                 "(4 = 0.75 dB steps, the default — shrinks the "
                 "container's largest member ~3.4x at measured-unchanged "
                 "quality; 0 = legacy raw-bfloat16 sidecars, "
                 "byte-compatible with older decoders)",
        )
        p.add_argument(
            "--precision", choices=["highest", "high", "default", "int8"],
            default="highest",
            help="matmul precision ladder for the whole pipeline; "
                 "'default' (TF32 on an H100) trades matmul accuracy "
                 "for speed at unchanged quantized quality and is "
                 "recorded in the container. 'int8' runs the MDCT "
                 "analysis as int8 matmuls (~-0.1 dB; the Bark matmuls "
                 "stay on 'default')",
        )
        p.add_argument(
            "--kbps", type=float, default=0.0,
            help="target bitrate (rate control via threshold scaling; "
                 "0 = native VBR)",
        )
        p.add_argument(
            "--ms", action="store_true",
            help="joint mid/side coding for stereo inputs",
        )
        p.add_argument(
            "--deadzone", default="auto",
            help="zero-bin half-width in quantizer steps (0.5 = plain "
                 "rounding, up to 2.0). 'auto' widens the zero bin at low "
                 "--kbps targets, where it measures +0.5..1.8 dB SNR at "
                 "matched bitrate; without --kbps 'auto' is plain rounding",
        )
        p.add_argument(
            "--tns", action="store_true",
            help="temporal noise shaping: whiten transient frames along "
                 "frequency before quantization so the decoder's inverse "
                 "filter concentrates quantization noise under attacks "
                 "instead of smearing it as pre-echo",
        )
        p.add_argument(
            "--nf", action="store_true",
            help="noise filling: transmit ~1 byte/frame of fill levels so "
                 "the decoder re-synthesizes quantizer-zeroed bins with "
                 "shaped noise — repairs the 'spectral holes' timbre at "
                 "low --kbps targets",
        )
        p.add_argument(
            "--bwe", action="store_true",
            help="bandwidth extension: rebuild quantizer-zeroed bins "
                 "above ~10.5 kHz by copying the decoded low band up in "
                 "frequency, scaled to transmitted per-group envelopes "
                 "(~1 byte per frame/group/channel) — restores harmonic "
                 "brightness at low --kbps targets where --nf alone "
                 "paints hiss",
        )
        p.add_argument(
            "--intensity", action="store_true",
            help="intensity stereo (needs --ms): stop coding the side "
                 "channel above ~6 kHz and transmit one signed pan gain "
                 "per frame/16-bin group instead; the decoder rebuilds "
                 "the stereo image from the mid channel. Measured "
                 "+2.7 dB SNR at matched bytes on panned content; side "
                 "content uncorrelated with the mid is dropped up "
                 "there, so reserve it for low --kbps targets",
        )
        p.add_argument(
            "--tmask", type=float, default=0.0,
            help="forward (post-)masking decay in dB per second (0 = "
                 "off; ~130 matches the literature's 100-200 ms "
                 "post-masking span). Raises masking thresholds in the "
                 "frames after a loud sound, spending fewer bits where "
                 "noise is inaudible. Encoder-side only — decoders need "
                 "no flag",
        )
        p.add_argument(
            "--preset", choices=["archive", "music", "low"], default=None,
            help="bundle of coded-path settings (each only applies where "
                 "you left the individual flag at its default): 'archive' "
                 "= plain rounding, no coding tools (bit-least-surprising"
                 "); 'music' = --deadzone auto --tns --bs (the measured "
                 "pre-echo + rate-adaptive ladder, QUALITY.md); 'low' = "
                 "music plus --nf --tmask 130 --bwe (for targets under "
                 "~64 kbps/channel: spectral-hole repair, post-masking "
                 "bit savings, and high-band replication) — and with "
                 "--ms also --intensity (pan-coded high band, "
                 "STEREO.md)",
        )
        p.add_argument(
            "--tag-loudness", action="store_true",
            help="measure the source's BS.1770 integrated loudness and "
                 "record it in the container — decode --normalize-lufs "
                 "then uses the tag instead of re-measuring",
        )
        p.add_argument(
            "--bs", action="store_true",
            help="block switching: transient frames quantize in a "
                 "time-split short basis (8 sub-spectra), confining "
                 "quantization noise to ~1/8 of the frame span — the "
                 "other pre-echo control besides --tns, and composable "
                 "with it",
        )
        p.add_argument(
            "--chunk-blocks", type=int, default=0,
            help="write a seekable .acs stream with this many MDCT blocks "
                 "per chunk (0 = monolithic .acz)",
        )
        p.add_argument(
            "--cbr", action="store_true",
            help="with --kbps and --chunk-blocks: constant bitrate — "
                 "every chunk is rate-controlled to the target "
                 "independently (one vmapped search) and carries its own "
                 "scale, so the local rate never drifts with content",
        )
        p.add_argument(
            "--reservoir", type=float, default=0.0, metavar="KBITS",
            help="with --cbr: bit reservoir — redistribute bits toward "
                 "hard chunks (measured by one uniform-quality ABR "
                 "pass) while the stream's running size never strays "
                 "more than KBITS kilobits from the constant-rate "
                 "schedule (0 = plain CBR; large = ABR's allocation "
                 "with per-chunk convergence)",
        )
        p.add_argument(
            "--dtx", type=float, nargs="?", const=-70.0, default=0.0,
            metavar="DBFS",
            help="with --chunk-blocks: discontinuous transmission — "
                 "chunks whose RMS sits below DBFS (default -70) become "
                 "~10-byte silent records; the decoder synthesizes "
                 "comfort noise at the recorded level. VBR streams "
                 "only (not --kbps/--cbr/--fec)",
        )
        p.add_argument(
            "--fec", type=float, nargs="?", const=4.0, default=0.0,
            metavar="SCALE",
            help="with --chunk-blocks: forward error correction for "
                 "lossy transports — every chunk also carries a coarse "
                 "redundant copy of the previous one (quantized SCALE "
                 "times coarser than the stream; default 4, measured "
                 "~10%% overhead on dense music), so decode rebuilds a "
                 "lost chunk from real spectral data instead of "
                 "concealing. Counted inside a --kbps target; decoders "
                 "use it automatically with --conceal",
        )
        p.add_argument(
            "--resample-to", type=int, default=0,
            help="resample the input to this rate before encoding "
                 "(polyphase windowed-sinc, ~90 dB stopband; 0 = keep "
                 "the file's rate)",
        )

    p = sub.add_parser("encode", help="wav -> .acz bitstream")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument(
        "--lossless", action="store_true",
        help="exact PCM coding (FLAC-class fixed predictors + Rice): "
             "decode reproduces the input bit-for-bit; 16/24-bit integer "
             "WAV only, and the lossy shaping flags do not apply",
    )
    p.add_argument(
        "--lossless-level", type=int, default=1, choices=(1, 2),
        help="1 = fixed predictors; 2 = order-searched quantized LPC "
             "per frame (FLAC -8-class ratios; native analysis, encode "
             "throughput at or above level 1; decode cost unchanged)",
    )
    add_model_args(p)
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("decode", help=".acz bitstream -> wav")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--bf16", action="store_true")
    p.add_argument(
        "--resample-to", type=int, default=0,
        help="resample the decoded audio to this rate before writing "
             "(0 = the stream's native rate)",
    )
    p.add_argument(
        "--start", type=float, default=0.0,
        help="decode starting at this time (seconds); for .acs streams "
             "this seeks by chunk without decoding the prefix",
    )
    p.add_argument(
        "--duration", type=float, default=0.0,
        help="decode at most this many seconds (0 = to the end)",
    )
    p.add_argument(
        "--normalize-lufs", type=float, default=0.0,
        help="gain the decoded audio to this integrated loudness "
             "(BS.1770 LUFS, e.g. -16), peak-guarded at -1 dBFS "
             "(0 = off)",
    )
    p.add_argument(
        "--conceal", action="store_true",
        help="packet-loss concealment for .acs streams: synthesize "
             "corrupt chunks (spectral repetition with an energy fade) "
             "instead of failing — playback semantics",
    )
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("roundtrip", help="wav -> wav through the codec")
    p.add_argument("input")
    p.add_argument("output")
    add_model_args(p)
    p.set_defaults(fn=cmd_roundtrip)

    p = sub.add_parser(
        "corpus", help="bulk-encode a directory of WAVs to .acz files"
    )
    p.add_argument("indir")
    p.add_argument("outdir")
    p.add_argument("--sample-rate", type=int, default=0,
                   help="corpus sample rate (no resampling is performed); "
                        "required for lossy encodes, not applicable with "
                        "--lossless (each file keeps its own rate)")
    p.add_argument("--clip-seconds", type=float, default=10.0,
                   help="uniform framing: clips truncate/zero-pad to this")
    p.add_argument("--channels", type=int, default=1)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--cache", default="",
                   help="raw-PCM cache .npy path: built on first run, "
                        "memmapped on repeat runs (skips WAV decoding)")
    p.add_argument(
        "--lossless", action="store_true",
        help="exact PCM archival of the whole directory (thread-pooled "
             "FLAC-class coding; 16/24-bit integer WAV, per-file rates)",
    )
    p.add_argument(
        "--lossless-level", type=int, default=1, choices=(1, 2),
        help="1 = fixed predictors; 2 = + order-searched per-frame "
             "quantized LPC (smaller at comparable encode speed)",
    )
    add_model_args(p)
    p.set_defaults(fn=cmd_corpus)

    p = sub.add_parser(
        "corpus-decode",
        help="bulk-decode a directory of .acz files to WAVs (batched, "
             "shape-bucketed device passes)",
    )
    p.add_argument("indir")
    p.add_argument("outdir")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--bf16", action="store_true",
                   help=argparse.SUPPRESS)  # dtype comes from the files
    p.set_defaults(fn=cmd_corpus_decode)

    p = sub.add_parser(
        "serve",
        help="serve the codec over TCP/Unix socket with dynamic batching",
    )
    p.add_argument("--sample-rate", type=int, required=True,
                   help="rate this server encodes at (clients must match)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8477)
    p.add_argument("--unix-socket", default="",
                   help="serve a Unix domain socket instead of TCP")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    add_model_args(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "eval",
        help="objective quality (SNR / segmental SNR / NMR) of a "
             "degraded wav vs its reference",
    )
    p.add_argument("reference")
    p.add_argument("degraded")
    p.add_argument("--json", action="store_true",
                   help="one JSON line instead of the table")
    add_model_args(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser(
        "resample", help="polyphase sample-rate conversion, wav -> wav"
    )
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--rate", type=int, required=True,
                   help="target sample rate in Hz")
    p.add_argument("--zeros", type=int, default=16,
                   help="sinc zero-crossings per side (quality; 16 ~= "
                        "90 dB stopband)")
    p.set_defaults(fn=cmd_resample)

    p = sub.add_parser("info", help="inspect an .acz bitstream")
    p.add_argument("input")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    _apply_preset(args, parser)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename}", file=sys.stderr)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
