"""Rate control: encode to a target bitrate.

The codec is natively VBR — bits follow the masking threshold. For
transport budgets, this module finds the threshold scale gamma whose
packed size hits a target bitrate: scaling every quantization step by
gamma > 1 coarsens codes monotonically (fewer bits, gracefully degrading
fidelity starting with the least audible content — the perceptual model
keeps ordering the damage).

Batched search instead of a serial bisection: all scale trials of a
round are one vmapped quantize (a single device pass), sizes come from
actually packing each trial on the host (entropy coding included), and a
second vmapped round refines each clip inside its own bracketing interval.
Two device passes replace ~10 sequential ones, and a whole batch of clips
is rate-controlled at once — each clip converging to its own scale.

    result = rate.encode_with_target_bitrate(codec, x, target_kbps=96)
    result.codes, result.bark16, result.threshold_scale, result.kbps

    results = rate.encode_with_target_bitrate_batch(codec, xs, 96.0)
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from audiocodec_tpu import blockswitch as _blockswitch
from audiocodec_tpu import bwe as _bwe
from audiocodec_tpu import intensity as _intensity
from audiocodec_tpu import nf as _nf
from audiocodec_tpu import quantize as _quantize
from audiocodec_tpu import tns as _tns
from audiocodec_tpu.io import bitstream as _bitstream


@dataclasses.dataclass
class RateControlResult:
    codes: np.ndarray
    bark16: np.ndarray
    threshold_scale: float
    kbps: float
    packed: bytes
    dz_recon: float = 0.0
    tns_idx: np.ndarray | None = None
    tns_band_start: int = 0
    nf_levels: np.ndarray | None = None
    nf_band_start: int = 0
    bs_flags: np.ndarray | None = None
    bwe_gains: np.ndarray | None = None
    bwe_start: int = 0
    is_gains: np.ndarray | None = None
    is_start: int = 0


def resolve_deadzone(deadzone, target_kbps, channels, sample_rate) -> float:
    """Resolve the dead-zone width for a target bitrate.

    "auto" picks from the target rate normalized to one 44.1 kHz channel,
    matching the measured matched-rate RD crossover (benchmarks/rd_curve.py
    --deadzone, N=1024 mono 44.1 kHz): at 40 kbps wide zones gain
    +0.4..+1.2 dB SNR (speech-like harmonics, pink noise, and tone stacks
    all agree, z=1.0 best on broadband / 0.9 on tonal); at ~96 kbps it is
    signal-dependent within +-0.5 dB (0.7 is the safe middle); at >=128
    plain rounding is never worse.
    """
    if deadzone != "auto":
        z = float(deadzone)
    else:
        kb = target_kbps / max(channels, 1) / (sample_rate / 44100.0)
        if kb >= 120.0:
            z = 0.5
        elif kb >= 80.0:
            z = 0.7
        elif kb >= 48.0:
            z = 0.9
        else:
            z = 1.0
    if not 0.5 <= z <= 2.0:
        raise ValueError(f"deadzone must be in [0.5, 2.0], got {z}")
    return z


def _meta(codec, ms):
    return dict(
        sample_rate=codec.psycho.sample_rate,
        filters_n=codec.mdct.filters_n,
        bark_bands_n=codec.psycho.bark_bands_n,
        alpha=codec.psycho.alpha,
        window_type=codec.mdct.window_type,
        compute_dtype=str(jnp.dtype(codec.mdct.compute_dtype)),
        ms=ms,
        bark_precision=codec.psycho.bark_precision,
        sidecar_grid=codec.sidecar_grid,
    )


def encode_with_target_bitrate_batch(
    codec,
    x,
    target_kbps: float,
    drown=0.0,
    tolerance: float = 0.05,
    trials_per_round: int = 8,
    log2_scale_range=(-4.0, 10.0),
    ms: bool = False,
    deadzone="auto",
    tns: bool = False,
    nf: bool = False,
    tmask: float = 0.0,
    bs: bool = False,
    bwe: bool = False,
    intensity: bool = False,
    orig_samples: int = 0,
    lufs=None,
) -> list:
    """Rate-control every clip of a batch to ``target_kbps``.

    :param x: waveform [B, samples, channels]; every clip gets its own
        threshold scale (bitrate is a per-clip property).
    :param tolerance: relative bitrate error under which round 1's grid is
        accepted for every clip and the refinement round is skipped.
    :param deadzone: zero-bin half-width (quantize.quantize), or "auto" to
        pick from the target rate (resolve_deadzone). All trials and the
        final pack share one value; its reconstruction offset is recorded
        in every container and returned as ``dz_recon``.
    :param tns: temporal noise shaping (tns.py). The filter decision and
        taps depend only on the spectrum's shape, not the step sizes, so
        they are computed ONCE here and every trial quantizes the same
        filtered spectrum — the indices ride every trial pack (they count
        toward the rate) and the final container.
    :param lufs: loudness tag — a scalar applied to every clip, or a
        per-clip sequence (loudness is a per-clip property; see
        metrics.loudness_lufs_batch).
    :param nf: noise filling (nf.py). Levels depend on the FINAL codes, so
        they are computed once for the winning scale and ride only the
        final container; trial packs omit them (the uint8-per-frame member
        deflates to a few bytes — well inside the rate tolerance).
    :param bwe: bandwidth extension (bwe.py). Gains also depend on the
        codes, but UNLIKE nf they are a per-(frame, group, channel)
        member whose deflated size is a real fraction of a low-rate
        budget — so every trial computes and packs its own gains (one
        extra vmapped device pass per round) and the measured sizes are
        honest.
    :return: list of B :class:`RateControlResult`.
    """
    batch = x.shape[0]
    target_kbps = np.asarray(target_kbps, dtype=float)
    if not (np.isfinite(target_kbps).all() and (target_kbps > 0).all()):
        raise ValueError(f"target_kbps must be positive, got {target_kbps}")
    if target_kbps.ndim > 1 or (
        target_kbps.ndim == 1 and target_kbps.shape[0] != batch
    ):
        raise ValueError(
            f"target_kbps must be a scalar or one value per clip "
            f"({batch}), got shape {target_kbps.shape}"
        )
    seconds = x.shape[1] / codec.psycho.sample_rate
    dtype = codec.mdct.compute_dtype
    # trials and final packs share ONE dead zone (it rides the container
    # header); per-clip targets resolve it from their mean rate
    z = resolve_deadzone(
        deadzone, float(np.mean(target_kbps)), x.shape[-1],
        codec.psycho.sample_rate,
    )
    dz_recon = _quantize.dz_recon_offset(z) if z != 0.5 else 0.0

    # One-time analysis (the bitstream-critical derivation lives in ONE
    # place — Codec.analyze_for_quantization); trials only re-quantize+pack.
    spectrum_q, bark16, base_threshold, bs_flags_dev = (
        codec.analyze_for_quantization(
            codec.mdct.transform(x), drown, ms=ms, tmask=tmask, bs=bs
        )
    )
    bs_flags = None if bs_flags_dev is None else np.asarray(bs_flags_dev)
    tns_idx, tns_bs, tns_idx_dev = None, 0, None
    if tns:
        tns_bs = codec.tns_band_start

        @jax.jit
        def _tns_once(s):
            idx = _tns.analyze(s, tns_bs)
            if bs_flags_dev is not None:
                # short frames never TNS-filter (codec.quantize_frames_tns
                # applies the same gate)
                idx = jnp.where(bs_flags_dev[:, :, None, None],
                                jnp.zeros_like(idx), idx)
            return idx, _tns.filter_forward(s, idx, tns_bs)

        tns_idx_dev, spectrum_q = _tns_once(spectrum_q)
        tns_idx = np.asarray(tns_idx_dev)
    if bs_flags_dev is not None:
        # flags are scale-independent; split ONCE, every trial quantizes
        # the switched spectrum (mirrors the codec's encode order)
        spectrum_q = jax.jit(functools.partial(
            _blockswitch.split_spectrum,
            precision=codec.mdct.dct_precision,
        ))(spectrum_q, bs_flags_dev)

    def _trial_threshold(scale_b):
        thr = base_threshold * scale_b[:, None, None, None].astype(dtype)
        if tns_idx_dev is not None:
            # same operation ORDER as quantize_frames_tns and the
            # decoders: (thr * scale) then the TNS gain compensation —
            # f32 multiplication is not associative, and step sizes
            # must be bit-identical on both sides
            thr = _tns.scaled_threshold(thr, tns_idx_dev, tns_bs)
        if bs_flags_dev is not None:
            # pooling LAST, after every scaling — the decoders mirror it
            thr = _blockswitch.pool_threshold(thr, bs_flags_dev)
        return thr

    is_excl, is_bs = None, 0
    if intensity:
        if not ms:
            raise ValueError("intensity stereo requires ms=True")
        is_bs = codec.is_start
        is_excl = jnp.asarray(
            _intensity.owned_mask(codec.mdct.filters_n, is_bs)
        )

    bwe_fn, bwe_bs = None, 0
    if bwe:
        bwe_bs = codec.bwe_start

        @jax.jit
        def bwe_fn(scale_b, codes):
            delta = _quantize.step_size(_trial_threshold(scale_b))
            g = _bwe.analyze(spectrum_q, codes, delta, bwe_bs,
                             exclude=is_excl)
            if bs_flags_dev is not None:
                g = jnp.where(bs_flags_dev[:, :, None, None],
                              jnp.zeros_like(g), g)
            return g

    nf_fn, nf_bs = None, 0
    if nf:
        nf_bs = codec.nf_band_start

        @jax.jit
        def nf_fn(scale_b, codes):
            delta = _quantize.step_size(_trial_threshold(scale_b))
            nfl = _nf.analyze(spectrum_q, codes, delta, nf_bs, deadzone=z,
                              band_end=bwe_bs if bwe else None,
                              exclude=is_excl)
            if bs_flags_dev is not None:
                nfl = jnp.where(bs_flags_dev[:, :, None],
                                jnp.zeros_like(nfl), nfl)
            return nfl

    is_fn = None
    if intensity:

        @jax.jit
        def is_fn(scale_b, codes):
            delta = _quantize.step_size(_trial_threshold(scale_b))
            mid_ref = None
            if bwe:
                # project onto the bwe-reconstructed mid, exactly as
                # the shipped encode will (codec._intensity_gains)
                mid_ref = _intensity.mid_reference(
                    codes, delta, dtype,
                    bwe_gains=bwe_fn(scale_b, codes),
                    bwe_start=bwe_bs, exclude=is_excl,
                )
            g = _intensity.analyze(spectrum_q, codes, delta, is_bs,
                                   mid_ref=mid_ref)
            if bs_flags_dev is not None:
                g = jnp.where(bs_flags_dev[:, :, None],
                              jnp.zeros_like(g), g)
            return g

    @jax.jit
    def quantize_trials(scales):
        """scales [K, B] -> codes [K, B, blocks, N, C]: every trial of the
        round in one device pass (vmap over the scale axis; each clip sees
        its own column). With intensity the forced side-band zeroing is
        applied HERE — it is scale-independent, and the trial sizes must
        measure the codes the container will actually ship."""

        def one(scale_b):
            codes = _quantize.quantize(
                spectrum_q, _trial_threshold(scale_b), deadzone=z
            )[0]
            if intensity:
                codes = _intensity.force_codes(codes, is_bs, bs_flags_dev)
            return codes

        return jax.vmap(one)(scales)

    meta = _meta(codec, ms)
    if orig_samples:
        # exact-length (gapless) round trips: the container records the
        # pre-padding sample count; trial packs carry it too so trial
        # and final sizes stay aligned
        meta["orig_samples"] = int(orig_samples)
    bark_np = np.asarray(bark16)

    # K x B trial packs between the two device passes were the measured
    # host bottleneck at batch scale (a 64-clip batch at 8 trials = 512+
    # sequential packs). The native Rice coder and zlib both release the
    # GIL, so a thread pool turns that into a cores-wide fan-out; the
    # pure-Python Rice fallback degrades gracefully to serial speed.
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(
        max_workers=min(32, (_os.cpu_count() or 4))
    )
    try:
        lufs_per_clip = None
        if lufs is not None:
            lufs_per_clip = (
                [float(v) for v in lufs]
                if np.ndim(lufs) > 0 or isinstance(lufs, (list, tuple))
                else [float(lufs)] * batch
            )
            if len(lufs_per_clip) != batch:
                raise ValueError(
                    f"lufs needs one value per clip ({batch}), got "
                    f"{len(lufs_per_clip)}"
                )
        return _search(
            pool, quantize_trials, bark_np, meta, batch, seconds, dtype,
            target_kbps, tolerance, trials_per_round, log2_scale_range,
            dz_recon, tns_idx, tns_bs, nf_fn, nf_bs, bs_flags,
            lufs_per_clip, bwe_fn, bwe_bs, is_fn, is_bs,
        )
    finally:
        pool.shutdown(wait=False)


def _search(pool, quantize_trials, bark_np, meta, batch, seconds, dtype,
            target_kbps, tolerance, trials_per_round, log2_scale_range,
            dz_recon=0.0, tns_idx=None, tns_band_start=0,
            nf_fn=None, nf_band_start=0, bs_flags=None,
            lufs_per_clip=None, bwe_fn=None, bwe_band_start=0,
            is_fn=None, is_band_start=0):
    # scalar target or one per clip — the whole search is per-clip anyway
    target_kbps = np.broadcast_to(
        np.asarray(target_kbps, dtype=float), (batch,)
    )
    def _pack_one(codes_b, bark_b, scale, b, entropy="auto", nfl=None,
                  bweg=None, isg=None):
        return _bitstream.pack(
            codes_b, bark_b, threshold_scale=scale, entropy=entropy,
            dz_recon=dz_recon,
            tns_idx=None if tns_idx is None else tns_idx[b : b + 1],
            tns_band_start=tns_band_start,
            nf_levels=None if nfl is None else nfl[b : b + 1],
            nf_band_start=nf_band_start,
            bs_flags=None if bs_flags is None else bs_flags[b : b + 1],
            bwe_gains=None if bweg is None else bweg[b : b + 1],
            bwe_start=bwe_band_start,
            is_gains=None if isg is None else isg[b : b + 1],
            is_start=is_band_start,
            lufs=None if lufs_per_clip is None else lufs_per_clip[b],
            **meta
        )

    from audiocodec_tpu import native as _native

    # Trials must pack with the SAME coder selection the final pack
    # ships ("auto" = best of rice/rrice post-deflate), or the search
    # converges on a size the container won't have: the auto pick flips
    # to rice at coarse scales on tonal content, where a pinned-rrice
    # trial overestimates by 5-6% — measured as a systematic ~10%
    # bitrate undershoot. The 2x coder work is host-side C++ on
    # kilobyte buffers, far below the device quantize pass it rides.
    trial_entropy = "auto" if _native.available() else "zlib"

    def sizes(log2_scales):
        """Pack every (trial, clip) concurrently; return kbps [K, B]."""
        scales_dev = jnp.exp2(jnp.asarray(log2_scales))
        codes_dev = quantize_trials(scales_dev)
        codes = np.asarray(codes_dev)
        gains = None
        if bwe_fn is not None:
            # gains cost real kbps at low rates — every trial carries its
            # own so measured sizes stay honest (one vmapped pass/round)
            gains = np.asarray(
                jax.vmap(bwe_fn)(scales_dev.astype(dtype), codes_dev)
            )
        igains = None
        if is_fn is not None:
            igains = np.asarray(
                jax.vmap(is_fn)(scales_dev.astype(dtype), codes_dev)
            )
        k_n = log2_scales.shape[0]
        pairs = [(k, b) for k in range(k_n) for b in range(batch)]
        packs = pool.map(
            lambda kb: len(
                _pack_one(
                    codes[kb[0], kb[1] : kb[1] + 1],
                    bark_np[kb[1] : kb[1] + 1],
                    float(2.0 ** log2_scales[kb[0], kb[1]]),
                    kb[1],
                    entropy=trial_entropy,
                    bweg=None if gains is None else gains[kb[0]],
                    isg=None if igains is None else igains[kb[0]],
                )
            ),
            pairs,
        )
        kbps = np.empty(log2_scales.shape)
        for (k, b), nbytes in zip(pairs, packs):
            kbps[k, b] = nbytes * 8 / seconds / 1000
        return kbps

    k_trials = max(4, trials_per_round)
    lo, hi = log2_scale_range
    # Round 1: a shared log-spaced grid brackets each clip's target.
    grid1 = np.broadcast_to(
        np.linspace(lo, hi, k_trials)[:, None], (k_trials, batch)
    ).copy()
    kbps1 = sizes(grid1)

    # Refinement rounds: while any clip is outside tolerance, re-grid each
    # clip inside its tightest bracketing interval (kbps is monotone
    # nonincreasing in the scale). Most signals exit after round 1 or 2;
    # steep rate curves (wide dead zones, tonal content) may take more —
    # each extra round shrinks the bracket ~(k_trials+1)x.
    all_grids, all_kbps = grid1, kbps1
    for _ in range(3):
        best = np.min(np.abs(all_kbps - target_kbps), axis=0)
        if bool((best <= tolerance * target_kbps).all()):
            break
        grid_next = np.empty_like(grid1)
        for b in range(batch):
            above = all_kbps[:, b] >= target_kbps[b]
            below = all_kbps[:, b] <= target_kbps[b]
            g_lo = all_grids[above, b].max() if above.any() else lo
            g_hi = all_grids[below, b].min() if below.any() else hi
            if g_hi < g_lo:
                g_lo, g_hi = g_hi, g_lo
            # interior points only — the endpoints were already probed
            grid_next[:, b] = np.linspace(g_lo, g_hi, k_trials + 2)[1:-1]
        kbps_next = sizes(grid_next)
        all_grids = np.concatenate([all_grids, grid_next], axis=0)
        all_kbps = np.concatenate([all_kbps, kbps_next], axis=0)

    # Final pass: every clip's winning scale in ONE device pass.
    k_best = np.argmin(np.abs(all_kbps - target_kbps), axis=0)
    win_scales = 2.0 ** all_grids[k_best, np.arange(batch)]
    # cast the winning scale straight to the compute dtype — routing it
    # through float32 would desync a float64 codec's final codes from the
    # full-precision threshold_scale the container records (the decoder
    # casts that recorded f64 value to the compute dtype the same way)
    win_codes_dev = quantize_trials(jnp.asarray(win_scales, dtype)[None, :])[0]
    win_codes = np.asarray(win_codes_dev)
    nfl = None
    if nf_fn is not None:
        # levels are a pure function of the winning (scale, codes) pair —
        # one extra device pass, final containers only
        nfl = np.asarray(
            nf_fn(jnp.asarray(win_scales, dtype), win_codes_dev)
        )
    win_gains = None
    if bwe_fn is not None:
        win_gains = np.asarray(
            bwe_fn(jnp.asarray(win_scales, dtype), win_codes_dev)
        )
    win_igains = None
    if is_fn is not None:
        win_igains = np.asarray(
            is_fn(jnp.asarray(win_scales, dtype), win_codes_dev)
        )
    final_packs = list(
        pool.map(
            lambda b: _pack_one(
                win_codes[b : b + 1],
                bark_np[b : b + 1],
                float(win_scales[b]),
                b,
                nfl=nfl,
                bweg=win_gains,
                isg=win_igains,
            ),
            range(batch),
        )
    )
    return [
        RateControlResult(
            codes=win_codes[b : b + 1],
            bark16=bark_np[b : b + 1],
            threshold_scale=float(win_scales[b]),
            kbps=len(final_packs[b]) * 8 / seconds / 1000,
            packed=final_packs[b],
            dz_recon=dz_recon,
            tns_idx=None if tns_idx is None else tns_idx[b : b + 1],
            tns_band_start=tns_band_start,
            nf_levels=None if nfl is None else nfl[b : b + 1],
            nf_band_start=nf_band_start,
            bs_flags=None if bs_flags is None else bs_flags[b : b + 1],
            bwe_gains=None if win_gains is None else win_gains[b : b + 1],
            bwe_start=bwe_band_start,
            is_gains=None if win_igains is None else win_igains[b : b + 1],
            is_start=is_band_start,
        )
        for b in range(batch)
    ]


def reservoir_allocate(demand, budget, reservoir, floor=0.0):
    """Bit-reservoir allocation: distribute ``budget`` bits over chunks
    proportionally to ``demand`` (the bits each chunk takes at UNIFORM
    quality — e.g. the per-chunk sizes of an ABR encode) while keeping the
    running deviation from the constant-rate schedule inside
    ``±reservoir`` bits — the transport guarantee a CBR buffer model
    needs, relaxed by one reservoir's worth of burstiness.

    The constraint is the classic decoder-buffer excursion bound: with
    per-chunk schedule ``share = budget / n``, every prefix must satisfy
    ``|sum(alloc[:i]) − i·share| ≤ reservoir``. ``reservoir = 0``
    degenerates to plain CBR (equal shares); ``reservoir ≥ max excursion
    of the demand`` reproduces the demand itself (ABR's allocation).

    Greedy forward waterfill: bits a chunk cannot spend (clamped by the
    bound) carry forward into the reservoir for later chunks — exactly how
    MP3/AAC reservoirs fill during easy passages — with a final
    renormalization so the total lands on ``budget``.

    :param demand: per-chunk demand in bits, shape [n].
    :param budget: total bits to distribute.
    :param reservoir: max absolute excursion in bits (≥ 0).
    :param floor: minimum bits per chunk (headers/sidecar floor).
    :return: per-chunk allocation in bits, shape [n], summing to ~budget.
    """
    demand = np.asarray(demand, dtype=float)
    n = demand.shape[0]
    if n == 0:
        return demand.copy()
    budget = float(budget)
    reservoir = float(reservoir)
    if reservoir < 0 or not np.isfinite(reservoir):
        raise ValueError(f"reservoir must be finite and >= 0: {reservoir}")
    if (demand < 0).any() or demand.sum() <= 0:
        raise ValueError("demand must be nonnegative with positive sum")
    share = budget / n

    def waterfill(t):
        out = np.empty_like(t)
        carry = 0.0  # unspendable bits banked for later chunks
        dv = 0.0
        for i in range(n):
            lo = max(share - reservoir - dv, floor)
            hi = max(share + reservoir - dv, floor)
            want = t[i] + carry
            out[i] = min(max(want, lo), hi)
            carry = want - out[i]
            dv += out[i] - share
        return out

    t = demand * (budget / demand.sum())
    for _ in range(8):
        dev = np.cumsum(t) - share * np.arange(1, n + 1)
        if (np.abs(dev) <= reservoir * (1 + 1e-9) + 1e-6).all() and (
            t >= floor - 1e-9
        ).all():
            break
        t = waterfill(t)
        # bits left un-placed (or over-placed) at the end: spread the
        # residual multiplicatively and re-clamp next iteration
        if t.sum() > 0:
            t *= budget / t.sum()
    # the excursion bound is HARD (a CBR decoder-buffer model relies on
    # it); the budget is best-effort within it. The renormalization above
    # can push chunks back over the bound, so the LAST operation must be
    # a clamping pass — idempotent on already-feasible schedules. Only
    # `floor` may override the bound (headers must fit).
    return waterfill(t)


def encode_with_target_bitrate(
    codec,
    x,
    target_kbps: float,
    drown=0.0,
    tolerance: float = 0.05,
    max_iters: int = 10,
    log2_scale_range=(-4.0, 10.0),
    ms: bool = False,
    deadzone="auto",
    tns: bool = False,
    nf: bool = False,
    tmask: float = 0.0,
    bs: bool = False,
    bwe: bool = False,
    intensity: bool = False,
    orig_samples: int = 0,
    lufs=None,
) -> RateControlResult:
    """Single-clip rate control (the batch path with B=1).

    :param x: waveform [1, samples, channels].
    :param max_iters: total trial budget (split over the two vmapped
        rounds; kept for API compatibility with the serial bisection).
    """
    if x.shape[0] != 1:
        raise ValueError(
            "encode_with_target_bitrate takes a single clip; use "
            "encode_with_target_bitrate_batch for batches"
        )
    return encode_with_target_bitrate_batch(
        codec,
        x,
        target_kbps,
        drown=drown,
        tolerance=tolerance,
        trials_per_round=max(4, (max_iters + 1) // 2),
        log2_scale_range=log2_scale_range,
        ms=ms,
        deadzone=deadzone,
        tns=tns,
        nf=nf,
        tmask=tmask,
        bs=bs,
        bwe=bwe,
        intensity=intensity,
        orig_samples=orig_samples,
        lufs=lufs,
    )[0]
