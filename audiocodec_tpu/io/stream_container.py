"""Seekable chunked stream container (.acs) for long-form encoded audio.

The monolithic .acz container (io/bitstream.py) holds one array of codes —
fine for clips, wrong for an hour of audio: decode would need the whole
file. This container stores independently-readable CHUNKS of spectral
frames with a byte index, so a decoder can stream sequentially with bounded
memory or seek to any chunk. Overlap-add needs exactly one spectral frame
of context (the MDCT's 2-tap coupling), so decoding from chunk k fetches
chunk k-1's last frame — nothing else.

Layout (little-endian):

  magic b"ACS1"/b"ACS2" | u32 header_len | header JSON (meta incl.
  chunk_blocks; "ACS2" iff the header carries "scq" — grid-quantized
  sidecars, which pre-scq readers would silently mis-decode)
  per chunk: u32 blocks | u32 codes_len | codes rice bytes
             | u32 bark_len | bark-delta rice bytes
             | [u32 tns_len | deflated int8 TNS indices — only when the
                header declares "tns"; see tns.py]
             | [u32 nfl_len | deflated uint8 noise-fill levels — only when
                the header declares "nf"; see nf.py]
             | [u32 bwe_len | deflated uint8 replication gains — only
                when the header declares "bwe"; see bwe.py]
             | [u32 isg_len | deflated uint8 intensity image gains —
                only when the header declares "isf"; see intensity.py]
             | [u32 bsw_len | packbits block-switch flag bitmap — only
                when the header declares "bs"; see blockswitch.py]
             | u32 crc32
             (crc over every payload — storage/transport corruption is
              detected at read time, not as garbled audio)
  trailer: u64 index offset at EOF-8; index = u64 chunk byte offsets

Codes and Bark sidecar use the same Rice coder as .acz; Bark deltas are
within-chunk only, so every chunk is self-contained.
"""

from __future__ import annotations

import json
import struct
import typing
import zlib

import numpy as np

# Wire versions. "ACS1" readers predate the grid-quantized sidecar
# (scq.py); an ACS1 reader handed a grid-quantized stream would decode
# the integer-level payload as bfloat16 deltas and play GARBAGE without
# any error, so streams whose bark payloads carry levels are stamped
# "ACS2" — old readers refuse loudly at the magic. Everything else
# (including every optional header feature old readers reject by key)
# stays ACS1, and this reader accepts both.
_MAGIC_V1 = b"ACS1"
_MAGIC_V2 = b"ACS2"
# "ACS3" — DTX streams only: every chunk body begins with a one-byte
# marker (0 = normal layout, 1 = a silent record: blocks + per-channel
# comfort-noise RMS levels instead of any coded members). Pre-DTX
# readers would misparse such bodies, so the magic makes them refuse
# loudly; non-DTX encodes keep their existing magic bytes unchanged.
_MAGIC_V3 = b"ACS3"

# Frame-count ceiling for DTX silent records (writer-validated,
# reader-enforced): 2^16 frames is >25 minutes of silence in ONE chunk
# at N=1024 — far beyond any sane chunking — and caps the synthetic
# zero-codes allocation a tampered record could demand at
# 2^16 * N * C int32s.
_SILENT_BLOCKS_CAP = 1 << 16


class Chunk(typing.NamedTuple):
    """One decoded chunk's payload (StreamReader.read_chunk)."""

    codes: np.ndarray  # int32 [blocks, N, C]
    bark: np.ndarray  # bfloat16 [blocks, bark_n, C or 1 (ms)]
    tns: np.ndarray | None  # int8 [blocks, order, C]; None = no TNS
    nfl: np.ndarray | None  # uint8 [blocks, C]; None = no noise filling
    tscale: float | None = None  # per-chunk rate scale (CBR streams)
    bsw: np.ndarray | None = None  # bool [blocks]; None = all-long
    bwe: np.ndarray | None = None  # uint8 [blocks, groups, C]; None = off
    isg: np.ndarray | None = None  # uint8 [blocks, groups]; None = off
    fec: bytes | None = None  # raw FEC member (redundant coarse coding
    #   of the PREVIOUS chunk — parse_fec_member); None = absent/empty
    silent: np.ndarray | None = None  # f32 [C] comfort-noise RMS levels
    #   (DTX streams only); set exactly on gated chunks — codes/bark are
    #   then synthesized zeros/floors so the chunk decodes through the
    #   standard step


# The FEC copy's own sidecar parameters. Grid: 3 dB steps (scq k2=1) —
# the copy is quantized >= 4x coarser than the stream, so a <= 1.5 dB
# threshold wobble sits far below its own quantization noise. Time
# pool: one sidecar row per 4 frames (the group's MAX masking
# intensity — codec.quantize_frames_fec). Both attack the same fact:
# the sidecar dominates a redundant copy's bytes (codes shrink with
# the fec scale, per-frame sidecar rows do not). Both are recorded per
# member, so the constants can change without breaking old streams.
_FEC_K2 = 1
_FEC_TPOOL = 4


def pack_fec_member(codes, bark16, tscale: float, meta: dict,
                    k2: int = _FEC_K2, tpool: int = _FEC_TPOOL) -> bytes:
    """Assemble a chunk's FEC member: a self-contained COARSE coding of
    the previous chunk — codes + time-pooled Bark sidecar + the
    absolute f64 threshold scale they were quantized with
    (self-contained so CBR streams, whose per-chunk scale is in the
    LOST chunk, stay recoverable). Layout inside the (length-prefixed)
    member:

      u32 blocks | f64 scale | u32 k2 | u32 tpool | u32 clen
      | codes | levels…end

    Codes ride the stream's own coder; the sidecar rides the member's
    OWN scq grid and time pool (the encoder must have quantized the
    codes against this grid's repeat-expanded snap —
    codec.quantize_frames_fec — for the step-size invariant to hold).
    ``bark16`` is the POOLED sidecar, [ceil(blocks/tpool), bark, C']."""
    from audiocodec_tpu import native
    from audiocodec_tpu import scq as _scq_mod

    codes = np.asarray(codes)
    bark = np.asarray(bark16)
    if codes.ndim == 4:
        codes = codes[0]
        bark = bark[0]
    blocks = codes.shape[0]
    if bark.shape[0] != -(-blocks // tpool):
        raise ValueError(
            f"pooled FEC sidecar has {bark.shape[0]} rows for {blocks} "
            f"frames at tpool={tpool}"
        )
    enc = (
        native.rrice_encode if meta["coder"] == "rrice"
        else native.rice_encode
    )
    code_bytes = enc(codes.astype(np.int32))
    bark_bytes = _scq_mod.encode_levels(
        _scq_mod.levels_from_bark16(bark, k2), block_axis=0
    )
    return (
        struct.pack("<IdII", blocks, float(tscale), int(k2), int(tpool))
        + struct.pack("<I", len(code_bytes))
        + code_bytes
        + bark_bytes
    )


def parse_fec_member(data: bytes, meta: dict):
    """FEC member bytes -> (codes int32 [blocks, N, C], bark bfloat16
    [blocks, bark_n, C or 1] — the pooled sidecar repeat-expanded back
    to per-frame rows, exactly as the encoder quantized against —
    scale float). Raises ValueError on any implausible field — the
    caller treats that as 'no redundancy'. The member arrived
    CRC-verified (it is chained into its carrying chunk's CRC), so
    these bounds guard logic errors and version skew, not bit flips."""
    from audiocodec_tpu import native
    from audiocodec_tpu import scq as _scq_mod

    if len(data) < 24:
        raise ValueError("FEC member too short")
    blocks, scale, k2, tpool = struct.unpack("<IdII", data[:20])
    (clen,) = struct.unpack("<I", data[20:24])
    import math as _math

    if not (_math.isfinite(scale) and 0 < scale < 2**32):
        raise ValueError(f"FEC scale {scale!r} out of bounds")
    if not k2:
        raise ValueError("FEC member sidecar grid must be nonzero")
    _scq_mod.validate_k2(k2)
    if not 1 <= tpool <= 256:
        raise ValueError(f"FEC member time pool {tpool} out of bounds")
    if clen > len(data) - 24:
        raise ValueError("FEC member codes length out of bounds")
    code_bytes = data[24 : 24 + clen]
    bark_bytes = data[24 + clen :]
    n = meta["filters_n"]
    bark_n = meta["bark_bands_n"]
    ch = meta["channels"]
    bark_ch = 1 if meta.get("ms", False) else ch
    coder = meta.get("coder", "rice")
    per_byte = 96 if coder == "rrice" else 8
    if blocks * n * ch > per_byte * clen or blocks > len(data):
        raise ValueError("FEC member demands implausible code count")
    g = -(-blocks // tpool)
    if g * bark_n * bark_ch > 96 * len(bark_bytes):
        raise ValueError("FEC member demands implausible sidecar count")
    decode = (
        native.rrice_decode if coder == "rrice" else native.rice_decode
    )
    codes = decode(code_bytes, blocks * n * ch).reshape(blocks, n, ch)
    pooled = _scq_mod.bark16_from_levels(
        _scq_mod.decode_levels(
            bark_bytes, (g, bark_n, bark_ch), block_axis=0
        ),
        k2, (g, bark_n, bark_ch),
    )
    bark = np.repeat(pooled, tpool, axis=0)[:blocks]
    return codes, bark, scale


class StreamWriter:
    """Append encoded chunks to a seekable stream file."""

    def __init__(self, path: str, *, sample_rate, filters_n, bark_bands_n,
                 alpha, window_type, channels, compute_dtype="float32",
                 ms: bool = False, threshold_scale: float = 1.0,
                 bark_precision: str = "highest", dz_recon: float = 0.0,
                 tns_order: int = 0, tns_band_start: int = 0,
                 nf: bool = False, nf_band_start: int = 0,
                 nf_seed: int = 0, cbr: bool = False,
                 bs: bool = False, bwe_start: int = 0,
                 is_start: int = 0,
                 sidecar_grid: int = 0,
                 fec_scale: float = 0.0,
                 dtx_level: float = 0.0,
                 orig_samples: int = 0, lufs=None):
        self.meta = {
            "sample_rate": int(sample_rate),
            "filters_n": int(filters_n),
            "bark_bands_n": int(bark_bands_n),
            "alpha": float(alpha),
            "window_type": window_type,
            "channels": int(channels),
            "compute_dtype": str(compute_dtype),
            # quantization-affecting knobs MUST ride the container so the
            # decoder derives bit-identical step sizes (CLAUDE.md invariant)
            "ms": bool(ms),
            "threshold_scale": float(threshold_scale),
            "bark_precision": str(bark_precision),
            # run-length Rice: every group falls back to plain Rice when
            # RLE doesn't pay, so this is never meaningfully larger and
            # 1.2-6x smaller on tonal/quiet chunks. Readers honor the
            # field; streams without it (older files) decode as "rice".
            "coder": "rrice",
            # "scq" (added below when nonzero): levels-per-octave of the
            # grid-quantized sidecar — chunk bark payloads then carry 2-D
            # delta-coded integer LEVELS (scq.py), ~3.4x smaller than
            # any coding of the bfloat16 bits. Absent = bfloat16 wire.
            # sidecar_grid=0 is the LEGACY-COMPAT mode: no "scq", no
            # "scoder" (sidecar rides the plain "coder"), magic ACS1 —
            # byte-readable by pre-scq decoders (see _MAGIC_V2 note).
            # header-field CRC coverage: the per-chunk blocks/length
            # fields are included in each chunk's CRC (a corrupted
            # blocks field otherwise silently TRUNCATES the decode —
            # the payload bytes still checksum clean). Older streams
            # without the flag keep payload-only CRCs.
            "hcrc": 1,
        }
        if orig_samples:
            # exact pre-padding length for gapless decode (see
            # io/bitstream.py nsamp); absent = no trim (legacy streams)
            if int(orig_samples) <= 0:
                raise ValueError(f"bad orig_samples: {orig_samples}")
            self.meta["nsamp"] = int(orig_samples)
        if lufs is not None:
            # loudness metadata (see io/bitstream.py lufs)
            from audiocodec_tpu.io import bitstream as _bs_fmt

            if not _bs_fmt.LUFS_MIN <= float(lufs) <= _bs_fmt.LUFS_MAX:
                raise ValueError(f"lufs out of range: {lufs}")
            self.meta["lufs"] = float(lufs)
        if dz_recon:
            # dead-zone reconstruction offset; absent = 0 (plain rounding)
            # so pre-dead-zone streams and default encodes are unchanged
            self.meta["dzr"] = float(dz_recon)
        if tns_order:
            # temporal noise shaping: each chunk carries per-frame int8
            # reflection indices; absent = no TNS (older streams decode
            # unchanged, and TNS-off encodes write the old layout)
            if not 0 < tns_order <= 32 or not (
                tns_order < tns_band_start < filters_n
            ):
                raise ValueError(
                    f"bad TNS config: order={tns_order}, "
                    f"band_start={tns_band_start}"
                )
            self.meta["tns"] = {
                "order": int(tns_order),
                "band_start": int(tns_band_start),
            }
        if nf:
            # noise filling: each chunk carries per-frame uint8 fill
            # levels; absent = no filling (older streams decode unchanged,
            # nf-off encodes write the old layout). The seed makes the
            # decoder's fill noise reproducible; levels index GLOBAL frame
            # positions, so chunked and seeking decodes are bit-identical.
            if not 0 <= nf_band_start < filters_n or not (
                0 <= nf_seed < 2**32
            ):
                raise ValueError(
                    f"bad noise-fill config: band_start={nf_band_start}, "
                    f"seed={nf_seed}"
                )
            self.meta["nf"] = {
                "band_start": int(nf_band_start),
                "seed": int(nf_seed),
            }
        if sidecar_grid:
            # grid-quantized sidecar: chunk bark payloads carry integer
            # levels (scq.py); absent = bfloat16 wire (older streams and
            # scq-off encodes write the old layout). Bitstream-critical:
            # the reader reconstructs the exact bfloat16 values through
            # the grid's shared table.
            from audiocodec_tpu import scq as _scq_mod

            _scq_mod.validate_k2(int(sidecar_grid))
            self.meta["scq"] = int(sidecar_grid)
        if bwe_start:
            # bandwidth extension: each chunk carries per-(frame, group,
            # channel) uint8 replication gains; absent = no replication
            # (older streams decode unchanged, bwe-off encodes write the
            # old layout). The crossover is bitstream-critical — it also
            # caps the noise fill's band on both sides (see bwe.py) —
            # and so is the group width, so both are validated against
            # this build's format constant like the bs factor.
            from audiocodec_tpu import bwe as _bwe_mod

            _bwe_mod.validate_start(filters_n, int(bwe_start))
            self.meta["bwe"] = {
                "start": int(bwe_start),
                "group": int(_bwe_mod.GROUP),
            }
        if is_start:
            # intensity stereo: each chunk carries per-(frame, group)
            # uint8 image gains; absent = fully-coded side (older
            # streams and intensity-off encodes write the old layout).
            # Requires joint stereo: the fill rebuilds side from mid.
            from audiocodec_tpu import intensity as _is_mod

            if not ms:
                raise ValueError(
                    "intensity streams require joint stereo (ms)"
                )
            _is_mod.validate_start(filters_n, int(is_start))
            self.meta["isf"] = {
                "start": int(is_start),
                "group": int(_is_mod.GROUP),
            }
        if bs:
            # block switching: each chunk carries a per-frame flag
            # bitmap; absent = all-long (older streams decode unchanged,
            # bs-off encodes write the old layout). Flags are
            # bitstream-critical: the decoder inverts the short basis
            # and pools thresholds for exactly these frames.
            from audiocodec_tpu import blockswitch as _bs_mod

            if filters_n % _bs_mod.FACTOR:
                raise ValueError(
                    f"block switching needs filters_n divisible by "
                    f"{_bs_mod.FACTOR}, got {filters_n}"
                )
            self.meta["bs"] = {"factor": int(_bs_mod.FACTOR)}
        if fec_scale:
            # forward error correction (the Opus-LBRR pattern): every
            # chunk additionally carries a COARSE redundant coding of the
            # PREVIOUS chunk's frames (plain quantize at threshold scale
            # x fec_scale, no feature ladder), so a lost/corrupt chunk is
            # rebuilt from real — if blunt — spectral data out of its
            # successor instead of extrapolated. Absent = no redundancy
            # (older streams decode unchanged); pre-fec readers fail a
            # fec stream's chunk CRCs loudly rather than mis-parse.
            if not 1.0 <= float(fec_scale) <= 256.0:
                raise ValueError(
                    f"fec_scale must be in [1, 256], got {fec_scale}"
                )
            self.meta["fec"] = {"scale": float(fec_scale)}
        if dtx_level:
            # discontinuous transmission: gated (near-silent) chunks are
            # written as tiny silent records (append_silent) instead of
            # coded members; the level (dBFS) is informational — the
            # DECODE contract is carried per chunk. DTX streams bump the
            # magic to ACS3 (pre-DTX readers would misparse the marker
            # byte every chunk body now starts with).
            if not -200.0 < float(dtx_level) < 0.0:
                raise ValueError(
                    f"dtx_level must be a negative dBFS gate, got "
                    f"{dtx_level}"
                )
            if fec_scale or cbr:
                raise ValueError(
                    "dtx does not compose with fec or cbr streams (a "
                    "silent record carries no members for the FEC chain "
                    "or a per-chunk scale to ride)"
                )
            self.meta["dtx"] = {"level": float(dtx_level)}
        if cbr:
            # constant-bitrate mode: every chunk carries its OWN f64
            # threshold scale (leading the chunk, CRC-covered); the
            # header's threshold_scale becomes the fallback for readers
            # of chunks that predate the flag (never written here)
            self.meta["cbr"] = 1
        if isinstance(path, (str, bytes)):
            self._f = open(path, "wb")
            self._owns_file = True
        else:
            # file-like sink (e.g. BytesIO): the streaming server builds
            # byte-exact .acs fragments through the SAME writer
            self._f = path
            self._owns_file = False
        header = json.dumps(self.meta).encode()
        if "dtx" in self.meta:
            magic = _MAGIC_V3
        elif "scq" in self.meta:
            magic = _MAGIC_V2
        else:
            magic = _MAGIC_V1
        self._f.write(magic + struct.pack("<I", len(header)) + header)
        self._index = []
        self._closed = False

    def append(self, codes, bark16, tns_idx=None, nf_levels=None,
               tscale=None, bs_flags=None, bwe_gains=None,
               is_gains=None, fec=None) -> None:
        """Write one chunk: codes int32 [1, blocks, N, C] (or [blocks, N, C]),
        bark16 bfloat16 [1, blocks, bark_n, C] (or unbatched), for TNS
        streams int8 reflection indices [1, blocks, order, C], for
        noise-filling streams uint8 levels [1, blocks, C], for CBR
        streams this chunk's threshold scale, for bandwidth-extension
        streams uint8 replication gains [1, blocks, groups, C], and for
        intensity streams uint8 image gains [1, blocks, groups]."""
        from audiocodec_tpu import native

        codes = np.asarray(codes)
        bark = np.asarray(bark16)
        if codes.ndim == 4:
            if codes.shape[0] != 1:
                raise ValueError("stream chunks are single-clip")
            codes = codes[0]
            bark = bark[0]
        blocks = codes.shape[0]
        tns = self.meta.get("tns")
        if (tns is not None) != (tns_idx is not None):
            raise ValueError(
                "chunk TNS indices must be passed exactly when the stream "
                "header declares TNS"
            )
        nf = self.meta.get("nf")
        if (nf is not None) != (nf_levels is not None):
            raise ValueError(
                "chunk noise-fill levels must be passed exactly when the "
                "stream header declares nf"
            )
        bsw = self.meta.get("bs")
        if (bsw is not None) != (bs_flags is not None):
            raise ValueError(
                "chunk block-switch flags must be passed exactly when "
                "the stream header declares bs"
            )
        bwe_meta = self.meta.get("bwe")
        if (bwe_meta is not None) != (bwe_gains is not None):
            raise ValueError(
                "chunk replication gains must be passed exactly when "
                "the stream header declares bwe"
            )
        is_meta = self.meta.get("isf")
        if (is_meta is not None) != (is_gains is not None):
            raise ValueError(
                "chunk intensity gains must be passed exactly when "
                "the stream header declares isf"
            )
        fec_meta = self.meta.get("fec")
        if (fec_meta is not None) != (fec is not None):
            raise ValueError(
                "chunk FEC bytes must be passed exactly when the stream "
                "header declares fec (pass b'' for the first chunk)"
            )
        cbr = self.meta.get("cbr")
        if (cbr is not None) != (tscale is not None):
            raise ValueError(
                "chunk threshold scale must be passed exactly when the "
                "stream header declares cbr"
            )
        if cbr is not None and not 0 < float(tscale) < 2**32:
            raise ValueError(f"chunk threshold scale out of range: {tscale}")
        enc = (
            native.rrice_encode
            if self.meta["coder"] == "rrice"
            else native.rice_encode
        )
        code_bytes = enc(codes.astype(np.int32))
        from audiocodec_tpu.io import bitstream as _bitstream

        scq_k2 = self.meta.get("scq", 0)
        if scq_k2:
            from audiocodec_tpu import scq as _scq_mod

            bark_bytes = _scq_mod.encode_levels(
                _scq_mod.levels_from_bark16(bark, scq_k2), block_axis=0
            )
        else:
            bark_bytes = _bitstream.encode_bark_sidecar(
                bark, block_axis=0,
                coder=self.meta.get("scoder", self.meta["coder"]),
            )
        tns_bytes = b""
        if tns is not None:
            ti = np.ascontiguousarray(tns_idx, dtype=np.int8)
            if ti.ndim == 4:
                ti = ti[0]
            if ti.shape != (blocks, tns["order"], codes.shape[-1]):
                raise ValueError(
                    f"chunk tns_idx shape {ti.shape} != "
                    f"({blocks}, {tns['order']}, {codes.shape[-1]})"
                )
            # mostly zero (frames where the gain gate didn't fire):
            # deflate collapses the zero runs
            tns_bytes = zlib.compress(ti.tobytes(), 6)
        nfl_bytes = b""
        if nf is not None:
            lv = np.ascontiguousarray(nf_levels, dtype=np.uint8)
            if lv.ndim == 3:
                lv = lv[0]
            if lv.shape != (blocks, codes.shape[-1]):
                raise ValueError(
                    f"chunk nf_levels shape {lv.shape} != "
                    f"({blocks}, {codes.shape[-1]})"
                )
            nfl_bytes = zlib.compress(lv.tobytes(), 6)
        bwe_bytes = b""
        if bwe_meta is not None:
            from audiocodec_tpu import bwe as _bwe_mod

            gz = np.ascontiguousarray(bwe_gains, dtype=np.uint8)
            if gz.ndim == 4:
                gz = gz[0]
            groups = _bwe_mod.n_groups(
                self.meta["filters_n"], bwe_meta["start"]
            )
            if gz.shape != (blocks, groups, codes.shape[-1]):
                raise ValueError(
                    f"chunk bwe_gains shape {gz.shape} != "
                    f"({blocks}, {groups}, {codes.shape[-1]})"
                )
            # smooth envelopes: deflate eats the small-delta structure
            bwe_bytes = zlib.compress(gz.tobytes(), 6)
        isg_bytes = b""
        if is_meta is not None:
            from audiocodec_tpu import intensity as _is_mod

            gz = np.ascontiguousarray(is_gains, dtype=np.uint8)
            if gz.ndim == 3:
                gz = gz[0]
            groups = _is_mod.n_groups(
                self.meta["filters_n"], is_meta["start"]
            )
            if gz.shape != (blocks, groups):
                raise ValueError(
                    f"chunk is_gains shape {gz.shape} != "
                    f"({blocks}, {groups})"
                )
            # pans are stable frame to frame: deflate eats the runs
            isg_bytes = zlib.compress(gz.tobytes(), 6)
        bsw_bytes = b""
        if bsw is not None:
            from audiocodec_tpu import blockswitch as _bs_mod

            fl = np.asarray(bs_flags)
            if fl.ndim == 2:
                fl = fl[0]
            if fl.shape != (blocks,):
                raise ValueError(
                    f"chunk bs_flags shape {fl.shape} != ({blocks},)"
                )
            bsw_bytes = _bs_mod.pack_flags(fl[None])[0].tobytes()
        # the CRC covers the HEADER FIELDS too (hcrc streams), chained in
        # FILE ORDER: a flipped scale/blocks/length field must fail
        # loudly, not silently truncate or rescale the decode
        hdr_codes = struct.pack("<II", blocks, len(code_bytes))
        hdr_bark = struct.pack("<I", len(bark_bytes))
        crc = 0
        self._index.append(self._f.tell())
        if "dtx" in self.meta:
            # DTX bodies start with a marker byte: 0 = this normal layout
            crc = zlib.crc32(b"\x00", crc)
            self._f.write(b"\x00")
        if cbr is not None:
            ts_bytes = struct.pack("<d", float(tscale))
            crc = zlib.crc32(ts_bytes, crc)
            self._f.write(ts_bytes)
        crc = zlib.crc32(code_bytes, zlib.crc32(hdr_codes, crc))
        crc = zlib.crc32(bark_bytes, zlib.crc32(hdr_bark, crc))
        self._f.write(hdr_codes)
        self._f.write(code_bytes)
        self._f.write(hdr_bark)
        self._f.write(bark_bytes)
        if tns is not None:
            hdr = struct.pack("<I", len(tns_bytes))
            crc = zlib.crc32(tns_bytes, zlib.crc32(hdr, crc))
            self._f.write(hdr)
            self._f.write(tns_bytes)
        if nf is not None:
            hdr = struct.pack("<I", len(nfl_bytes))
            crc = zlib.crc32(nfl_bytes, zlib.crc32(hdr, crc))
            self._f.write(hdr)
            self._f.write(nfl_bytes)
        if bwe_meta is not None:
            hdr = struct.pack("<I", len(bwe_bytes))
            crc = zlib.crc32(bwe_bytes, zlib.crc32(hdr, crc))
            self._f.write(hdr)
            self._f.write(bwe_bytes)
        if is_meta is not None:
            hdr = struct.pack("<I", len(isg_bytes))
            crc = zlib.crc32(isg_bytes, zlib.crc32(hdr, crc))
            self._f.write(hdr)
            self._f.write(isg_bytes)
        if bsw is not None:
            hdr = struct.pack("<I", len(bsw_bytes))
            crc = zlib.crc32(bsw_bytes, zlib.crc32(hdr, crc))
            self._f.write(hdr)
            self._f.write(bsw_bytes)
        if fec_meta is not None:
            fec = bytes(fec)
            hdr = struct.pack("<I", len(fec))
            crc = zlib.crc32(fec, zlib.crc32(hdr, crc))
            self._f.write(hdr)
            self._f.write(fec)
        self._f.write(struct.pack("<I", crc))

    def append_silent(self, blocks: int, levels) -> None:
        """Write one DTX silent record: marker 1, the frame count, and
        one float32 comfort-noise RMS level per channel (0.0 = decode to
        digital silence). ~(9 + 4*C) bytes instead of a coded chunk.
        Only valid on streams created with ``dtx_level``."""
        if "dtx" not in self.meta:
            raise ValueError(
                "append_silent requires a DTX stream (dtx_level set)"
            )
        lv = np.asarray(levels, dtype=np.float64).ravel()
        if lv.shape != (self.meta["channels"],):
            raise ValueError(
                f"need one level per channel ({self.meta['channels']}), "
                f"got shape {lv.shape}"
            )
        if not (np.isfinite(lv).all() and (lv >= 0).all()):
            raise ValueError(f"bad comfort-noise levels: {lv!r}")
        # canonicalize onto a 0.5 dB log grid: comfort-noise levels need
        # nowhere near f32 resolution, and snapping makes the wire bytes
        # deterministic across RMS computation paths (offline device f32
        # vs live-session host f64 differ in the last ulp)
        nz = lv > 1e-12
        lv = np.where(
            nz,
            10.0 ** (np.round(
                40.0 * np.log10(np.maximum(lv, 1e-12))
            ) / 40.0),
            0.0,
        ).astype(np.float32)
        blocks = int(blocks)
        if not 0 < blocks <= _SILENT_BLOCKS_CAP:
            raise ValueError(
                f"silent record blocks out of range (1..{_SILENT_BLOCKS_CAP}): "
                f"{blocks}"
            )
        body = b"\x01" + struct.pack("<I", blocks) + lv.tobytes()
        self._index.append(self._f.tell())
        crc = zlib.crc32(body, 0)
        self._f.write(body)
        self._f.write(struct.pack("<I", crc))

    def close(self) -> None:
        if self._closed:
            return
        index_off = self._f.tell()
        self._f.write(struct.pack(f"<{len(self._index)}Q", *self._index))
        self._f.write(struct.pack("<QQ", len(self._index), index_off))
        if self._owns_file:
            self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StreamReader:
    """Random or sequential access to an .acs stream."""

    def __init__(self, path):
        import os

        if isinstance(path, (str, bytes)):
            self._f = open(path, "rb")
            self._size = os.fstat(self._f.fileno()).st_size
            self._owns_file = True
        else:
            # file-like source (e.g. BytesIO of a network-assembled
            # stream): seekable with a known end; stays the caller's to
            # close (mirrors StreamWriter)
            self._f = path
            self._f.seek(0, 2)
            self._size = self._f.tell()
            self._f.seek(0)
            self._owns_file = False
        magic = self._f.read(4)
        if magic not in (_MAGIC_V1, _MAGIC_V2, _MAGIC_V3):
            raise ValueError(f"not an ACS stream (magic {magic!r})")
        try:
            (hlen,) = struct.unpack("<I", self._f.read(4))
            if hlen > self._size:
                raise ValueError("header length exceeds file size")
            self.meta = json.loads(self._f.read(hlen))
            self._f.seek(-16, 2)
            n_chunks, index_off = struct.unpack("<QQ", self._f.read(16))
            # every trailer field must point inside the file
            if (
                index_off + 8 * n_chunks + 16 > self._size
                or index_off < 8 + hlen
            ):
                raise ValueError("stream trailer/index out of bounds")
            self._f.seek(index_off)
            self._index = list(
                struct.unpack(f"<{n_chunks}Q", self._f.read(8 * n_chunks))
            )
            self._index_end = index_off
            if any(not 8 + hlen <= off < index_off for off in self._index):
                raise ValueError("chunk offsets out of bounds")
            self._validate_meta()
        except (struct.error, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(f"corrupt ACS stream: {e}") from None

    def _validate_meta(self) -> None:
        """Sanity-bound the untrusted JSON header before any field is used
        to size a decode allocation (a corrupt header must not be able to
        demand memory unrelated to the file's actual size)."""
        m = self.meta
        if not isinstance(m, dict):
            raise ValueError("stream header is not an object")
        for key, lo, hi in (
            ("filters_n", 2, 1 << 16),
            ("bark_bands_n", 1, 1 << 16),
            ("channels", 1, 64),
            ("sample_rate", 1, 10_000_000),
        ):
            v = m.get(key)
            if not isinstance(v, int) or not lo <= v <= hi:
                raise ValueError(
                    f"stream header field {key}={v!r} out of bounds "
                    f"[{lo}, {hi}] — corrupt stream"
                )
        if m["filters_n"] % 2 != 0:
            raise ValueError("stream header filters_n must be even")
        ts = m.get("threshold_scale", 1.0)
        if not isinstance(ts, (int, float)) or not 0 < ts < 2**32:
            raise ValueError(
                f"stream header threshold_scale={ts!r} out of bounds — "
                "corrupt stream"
            )
        if m.get("ms", False) and m["channels"] != 2:
            raise ValueError("stream header: ms coding requires 2 channels")
        dzr = m.get("dzr", 0.0)
        if not isinstance(dzr, (int, float)) or not -1.0 <= dzr <= 2.0:
            raise ValueError(
                f"stream header dzr={dzr!r} out of bounds — corrupt stream"
            )
        if m.get("bark_precision", "highest") not in (
            "highest", "high", "default"
        ):
            raise ValueError(
                "stream header bark_precision must be one of "
                "highest/high/default — corrupt stream"
            )
        scq_k2 = m.get("scq", 0)
        if scq_k2:
            from audiocodec_tpu import scq as _scq_mod

            if not isinstance(scq_k2, int):
                raise ValueError(
                    f"stream header scq={scq_k2!r} must be an integer — "
                    "corrupt stream"
                )
            try:
                _scq_mod.validate_k2(scq_k2)
            except ValueError as e:
                raise ValueError(
                    f"stream sidecar grid unsupported: {e} — written by "
                    "a newer framework version?"
                ) from None
        tns = m.get("tns")
        if tns is not None:
            order = tns.get("order") if isinstance(tns, dict) else None
            bs = tns.get("band_start") if isinstance(tns, dict) else None
            if (
                not isinstance(order, int) or not isinstance(bs, int)
                or not 0 < order <= 32 or not order < bs < m["filters_n"]
            ):
                raise ValueError(
                    f"stream header tns={tns!r} out of bounds — corrupt "
                    "stream"
                )
        nf = m.get("nf")
        if nf is not None:
            bs = nf.get("band_start") if isinstance(nf, dict) else None
            seed = nf.get("seed") if isinstance(nf, dict) else None
            if (
                not isinstance(bs, int) or not isinstance(seed, int)
                or not 0 <= bs < m["filters_n"] or not 0 <= seed < 2**32
            ):
                raise ValueError(
                    f"stream header nf={nf!r} out of bounds — corrupt "
                    "stream"
                )
        bsm = m.get("bs")
        if bsm is not None:
            factor = bsm.get("factor") if isinstance(bsm, dict) else None
            if (
                not isinstance(factor, int)
                or not 2 <= factor <= 64
                or m["filters_n"] % factor
            ):
                raise ValueError(
                    f"stream header bs={bsm!r} out of bounds — corrupt "
                    "stream"
                )
            from audiocodec_tpu import blockswitch as _bs_mod

            if factor != _bs_mod.FACTOR:
                # decode derives pooling groups and the inverse basis
                # from FACTOR; refuse a mismatch instead of decoding
                # wrong audio silently
                raise ValueError(
                    f"stream uses block-switch factor {factor}; this "
                    f"decoder supports {_bs_mod.FACTOR} (newer "
                    "framework version?)"
                )
        bwem = m.get("bwe")
        if bwem is not None:
            start = bwem.get("start") if isinstance(bwem, dict) else None
            group = bwem.get("group") if isinstance(bwem, dict) else None
            from audiocodec_tpu import bwe as _bwe_mod

            if not isinstance(start, int) or not isinstance(group, int):
                raise ValueError(
                    f"stream header bwe={bwem!r} out of bounds — corrupt "
                    "stream"
                )
            if group != _bwe_mod.GROUP:
                # the fill derives group slices and the copy-up map from
                # GROUP; refuse a mismatch instead of decoding wrong audio
                raise ValueError(
                    f"stream uses bwe group width {group}; this decoder "
                    f"supports {_bwe_mod.GROUP} (newer framework version?)"
                )
            try:
                _bwe_mod.validate_start(m["filters_n"], start)
            except ValueError as e:
                raise ValueError(f"corrupt stream: {e}") from None
        ism = m.get("isf")
        if ism is not None:
            start = ism.get("start") if isinstance(ism, dict) else None
            group = ism.get("group") if isinstance(ism, dict) else None
            from audiocodec_tpu import intensity as _is_mod

            if not isinstance(start, int) or not isinstance(group, int):
                raise ValueError(
                    f"stream header isf={ism!r} out of bounds — corrupt "
                    "stream"
                )
            if group != _is_mod.GROUP:
                # the fill derives group slices from GROUP; refuse a
                # mismatch instead of decoding wrong audio
                raise ValueError(
                    f"stream uses intensity group width {group}; this "
                    f"decoder supports {_is_mod.GROUP} (newer framework "
                    "version?)"
                )
            try:
                _is_mod.validate_start(m["filters_n"], start)
            except ValueError as e:
                raise ValueError(f"corrupt stream: {e}") from None
            if not m.get("ms"):
                raise ValueError(
                    "stream header declares intensity without joint "
                    "stereo — corrupt stream"
                )
        fecm = m.get("fec")
        if fecm is not None:
            sc = fecm.get("scale") if isinstance(fecm, dict) else None
            if not isinstance(sc, (int, float)) or not 1.0 <= sc <= 256.0:
                raise ValueError(
                    f"stream header fec={fecm!r} out of bounds — corrupt "
                    "stream"
                )
        if not isinstance(m.get("cbr", 0), (int, bool)):
            raise ValueError("stream header cbr must be a flag")
        ns = m.get("nsamp", 0)
        if not isinstance(ns, int) or ns < 0:
            raise ValueError(
                f"stream header nsamp={ns!r} out of bounds — corrupt "
                "stream"
            )
        lv = m.get("lufs")
        from audiocodec_tpu.io import bitstream as _bs_fmt

        if lv is not None and (
            not isinstance(lv, (int, float))
            or not _bs_fmt.LUFS_MIN <= lv <= _bs_fmt.LUFS_MAX
        ):
            raise ValueError(
                f"stream header lufs={lv!r} out of bounds — corrupt "
                "stream"
            )

    @property
    def n_chunks(self) -> int:
        return len(self._index)

    def chunk_blocks(self, i: int) -> int:
        """Number of spectral frames in chunk i (header read only)."""
        self._check_index(i)
        self._f.seek(self._index[i])
        # wire order (mirrors StreamWriter.append): DTX marker byte
        # first, then the f64 CBR scale, then the u32 frame count
        silent = False
        if self.meta.get("dtx") is not None:
            marker = self._read_exact(1, i)
            if marker not in (b"\x00", b"\x01"):
                raise ValueError(
                    f"chunk {i} has an unknown DTX marker — corrupt "
                    "stream"
                )
            silent = marker == b"\x01"
        if self.meta.get("cbr") and not silent:
            # silent records carry no scale: their u32 frame count
            # follows the marker directly
            self._f.seek(8, 1)
        (blocks,) = struct.unpack("<I", self._read_exact(4, i))
        return blocks

    def chunk_bytes(self, i: int) -> int:
        """On-wire byte size of chunk i, framing included (index read
        only — no chunk data is touched). The per-chunk sizes are the
        stream's bit-demand profile; the reservoir allocator feeds on
        them (rate.reservoir_allocate)."""
        self._check_index(i)
        end = (
            self._index[i + 1]
            if i + 1 < len(self._index)
            else self._index_end
        )
        size = end - self._index[i]
        if size <= 0:
            raise ValueError(f"chunk {i} index not increasing — corrupt")
        return size

    def _check_index(self, i: int) -> None:
        if not 0 <= i < len(self._index):
            raise IndexError(f"chunk {i} of {len(self._index)}")

    def _read_exact(self, nbytes: int, i: int) -> bytes:
        data = self._f.read(nbytes)
        if len(data) != nbytes:
            raise ValueError(f"chunk {i} truncated — corrupt stream")
        return data

    def read_chunk(self, i: int) -> "Chunk":
        """-> :class:`Chunk` (codes int32 [blocks, N, C], bark bfloat16
        [blocks, bark, C], tns int8 [blocks, order, C] | None, nfl uint8
        [blocks, C] | None)."""
        from audiocodec_tpu import native
        from audiocodec_tpu.io import bitstream as _bitstream

        self._check_index(i)
        self._f.seek(self._index[i])
        hcrc = bool(self.meta.get("hcrc"))
        want = 0
        tscale = None
        # wire order mirrors StreamWriter.append exactly: DTX marker
        # byte FIRST (when the stream declares dtx), then the f64 CBR
        # scale (when cbr) — dtx+cbr streams are currently rejected at
        # encode, but reader and writer must agree on the layout so
        # relaxing that restriction cannot silently misparse
        if self.meta.get("dtx") is not None:
            marker = self._read_exact(1, i)
            want = zlib.crc32(marker, want)
            if marker == b"\x01":
                return self._read_silent_record(i, want)
            if marker != b"\x00":
                raise ValueError(
                    f"chunk {i} has an unknown DTX marker — corrupt "
                    "stream"
                )
        if self.meta.get("cbr"):
            ts_bytes = self._read_exact(8, i)
            (tscale,) = struct.unpack("<d", ts_bytes)
            want = zlib.crc32(ts_bytes, want)
            import math as _math

            if not (_math.isfinite(tscale) and 0 < tscale < 2**32):
                raise ValueError(
                    f"chunk {i} threshold scale {tscale!r} out of bounds "
                    "— corrupt stream"
                )
        # hcrc streams chain the header fields into the CRC, so a
        # flipped blocks/length field fails the check instead of
        # silently truncating the decode (payload-only CRCs cannot see
        # it); payload bytes chain either way
        def chain(data, hdr=None):
            nonlocal want
            if hdr is not None and hcrc:
                want = zlib.crc32(hdr, want)
            want = zlib.crc32(data, want)

        def read_payload(what):
            """One length-prefixed member: the length field comes from
            the (potentially corrupt) file, so bound it by the file
            itself before allocating or reading."""
            hdr = self._read_exact(4, i)
            (length,) = struct.unpack("<I", hdr)
            if length > self._size:
                raise ValueError(
                    f"chunk {i} has implausible sizes — corrupt stream"
                )
            data = self._read_exact(length, i)
            chain(data, hdr)
            return data
        hdr_codes = self._read_exact(8, i)
        blocks, clen = struct.unpack("<II", hdr_codes)
        if blocks > self._size or clen > self._size:
            raise ValueError(f"chunk {i} has implausible sizes — corrupt stream")
        code_bytes = self._read_exact(clen, i)
        chain(code_bytes, hdr_codes)
        bark_bytes = read_payload("bark")
        tns_meta = self.meta.get("tns")
        tns_bytes = read_payload("tns") if tns_meta is not None else None
        nf_meta = self.meta.get("nf")
        nfl_bytes = read_payload("nfl") if nf_meta is not None else None
        bwe_meta = self.meta.get("bwe")
        bwe_bytes = read_payload("bwe") if bwe_meta is not None else None
        is_meta = self.meta.get("isf")
        isg_bytes = read_payload("isg") if is_meta is not None else None
        bs_meta = self.meta.get("bs")
        bsw_bytes = read_payload("bsw") if bs_meta is not None else None
        fec_meta = self.meta.get("fec")
        fec_bytes = read_payload("fec") if fec_meta is not None else None
        (crc,) = struct.unpack("<I", self._read_exact(4, i))
        if want != crc:
            raise ValueError(f"chunk {i} failed CRC — corrupt stream")

        n = self.meta["filters_n"]
        bark_n = self.meta["bark_bands_n"]
        ch = self.meta["channels"]
        # joint stereo stores the single min-channel Bark sidecar
        bark_ch = 1 if self.meta.get("ms", False) else ch
        # Plausibility bound before allocating the decode buffer: plain
        # Rice spends >= 1 bit/value (8 values/byte); run-length Rice
        # amortizes a 256-zero group to 22 bits (~93 values/byte).
        coder = self.meta.get("coder", "rice")
        if coder not in ("rice", "rrice"):
            raise ValueError(
                f"stream uses unsupported coder {coder!r} — written by a "
                "newer framework version?"
            )
        scoder = self.meta.get("scoder", coder)
        if scoder not in ("rice", "rrice", "rrice2d"):
            raise ValueError(
                f"stream uses unsupported sidecar coder {scoder!r} — "
                "written by a newer framework version?"
            )
        per_byte = 96 if coder == "rrice" else 8
        if blocks * n * ch > per_byte * clen:
            raise ValueError(
                f"chunk {i} header demands {blocks * n * ch} values from a "
                f"{clen}-byte payload — corrupt stream"
            )
        decode = (
            native.rrice_decode if coder == "rrice" else native.rice_decode
        )
        codes = decode(code_bytes, blocks * n * ch).reshape(
            blocks, n, ch
        )
        sper_byte = 8 if scoder == "rice" else 96
        if blocks * bark_n * bark_ch > sper_byte * len(bark_bytes):
            raise ValueError(
                f"chunk {i} header demands {blocks * bark_n * bark_ch} "
                f"sidecar values from a {len(bark_bytes)}-byte payload "
                "— corrupt stream"
            )
        scq_k2 = self.meta.get("scq", 0)
        if scq_k2:
            from audiocodec_tpu import scq as _scq_mod

            try:
                bark = _scq_mod.bark16_from_levels(
                    _scq_mod.decode_levels(
                        bark_bytes, (blocks, bark_n, bark_ch),
                        block_axis=0,
                    ),
                    scq_k2, (blocks, bark_n, bark_ch),
                )
            except ValueError as e:
                raise ValueError(f"chunk {i}: {e}") from None
        else:
            bark = _bitstream.decode_bark_sidecar(
                bark_bytes, (blocks, bark_n, bark_ch), block_axis=0,
                coder=scoder,
            )
        tns = None
        if tns_bytes is not None:
            order = tns_meta["order"]
            want_n = blocks * order * ch
            # cap the inflate at the expected size (+1 to detect excess) —
            # a tampered field must not drive an unbounded allocation
            try:
                d = zlib.decompressobj()
                raw = d.decompress(tns_bytes, want_n + 1)
            except zlib.error as e:
                raise ValueError(
                    f"chunk {i} TNS payload corrupt: {e}"
                ) from None
            if len(raw) != want_n:
                raise ValueError(
                    f"chunk {i} TNS payload is {len(raw)} bytes, "
                    f"expected {want_n} — corrupt stream"
                )
            tns = np.frombuffer(raw, dtype=np.int8).reshape(
                blocks, order, ch
            )
        nfl = None
        if nfl_bytes is not None:
            want_n = blocks * ch
            try:
                d = zlib.decompressobj()
                raw = d.decompress(nfl_bytes, want_n + 1)
            except zlib.error as e:
                raise ValueError(
                    f"chunk {i} noise-fill payload corrupt: {e}"
                ) from None
            if len(raw) != want_n:
                raise ValueError(
                    f"chunk {i} noise-fill payload is {len(raw)} bytes, "
                    f"expected {want_n} — corrupt stream"
                )
            nfl = np.frombuffer(raw, dtype=np.uint8).reshape(blocks, ch)
        bwe = None
        if bwe_bytes is not None:
            from audiocodec_tpu import bwe as _bwe_mod

            groups = _bwe_mod.n_groups(n, bwe_meta["start"])
            want_n = blocks * groups * ch
            try:
                d = zlib.decompressobj()
                raw = d.decompress(bwe_bytes, want_n + 1)
            except zlib.error as e:
                raise ValueError(
                    f"chunk {i} bwe payload corrupt: {e}"
                ) from None
            if len(raw) != want_n:
                raise ValueError(
                    f"chunk {i} bwe payload is {len(raw)} bytes, "
                    f"expected {want_n} — corrupt stream"
                )
            bwe = np.frombuffer(raw, dtype=np.uint8).reshape(
                blocks, groups, ch
            )
        isg = None
        if isg_bytes is not None:
            from audiocodec_tpu import intensity as _is_mod

            groups = _is_mod.n_groups(n, is_meta["start"])
            want_n = blocks * groups
            try:
                d = zlib.decompressobj()
                raw = d.decompress(isg_bytes, want_n + 1)
            except zlib.error as e:
                raise ValueError(
                    f"chunk {i} intensity payload corrupt: {e}"
                ) from None
            if len(raw) != want_n:
                raise ValueError(
                    f"chunk {i} intensity payload is {len(raw)} bytes, "
                    f"expected {want_n} — corrupt stream"
                )
            isg = np.frombuffer(raw, dtype=np.uint8).reshape(
                blocks, groups
            )
        bsw = None
        if bsw_bytes is not None:
            from audiocodec_tpu import blockswitch as _bs_mod

            want_n = (blocks + 7) // 8
            if len(bsw_bytes) != want_n:
                raise ValueError(
                    f"chunk {i} block-switch bitmap is {len(bsw_bytes)} "
                    f"bytes, expected {want_n} — corrupt stream"
                )
            bsw = _bs_mod.unpack_flags(
                np.frombuffer(bsw_bytes, dtype=np.uint8)[None], blocks
            )[0]
        return Chunk(codes, bark, tns, nfl, tscale, bsw, bwe, isg,
                     fec_bytes if fec_bytes else None)

    def _read_silent_record(self, i: int, want: int) -> "Chunk":
        """Parse a DTX silent record (marker already consumed and
        chained) into a synthetic Chunk that decodes through the
        STANDARD step: zero codes, a floor sidecar, and neutral feature
        members (zero reflection coefficients = identity TNS filter;
        level/gain 0 = no nf/bwe/intensity fill; all-long bs flags) —
        so carry evolution, seeks, and every decode path stay exactly
        the coded-chunk machinery."""
        import ml_dtypes

        hdr = self._read_exact(4, i)
        (blocks,) = struct.unpack("<I", hdr)
        ch = self.meta["channels"]
        # unlike coded chunks (whose frame counts are bounded against
        # their payload bytes), a silent record has no payload to bound
        # against — a tampered u32 here must not size a multi-gigabyte
        # zeros allocation, so the cap is explicit (and enforced at the
        # writer, so it is never a legitimate value)
        if not 0 < blocks <= _SILENT_BLOCKS_CAP:
            raise ValueError(
                f"chunk {i} has implausible sizes — corrupt stream"
            )
        lv_bytes = self._read_exact(4 * ch, i)
        want = zlib.crc32(lv_bytes, zlib.crc32(hdr, want))
        (crc,) = struct.unpack("<I", self._read_exact(4, i))
        if want != crc:
            raise ValueError(f"chunk {i} failed CRC — corrupt stream")
        levels = np.frombuffer(lv_bytes, dtype=np.float32).copy()
        if not np.isfinite(levels).all() or (levels < 0).any():
            raise ValueError(
                f"chunk {i} has bad comfort-noise levels — corrupt "
                "stream"
            )
        n = self.meta["filters_n"]
        bark_n = self.meta["bark_bands_n"]
        bark_ch = 1 if self.meta.get("ms", False) else ch
        codes = np.zeros((blocks, n, ch), np.int32)
        bark = np.full(
            (blocks, bark_n, bark_ch), 1e-9, dtype=ml_dtypes.bfloat16
        )
        tns_meta = self.meta.get("tns")
        tns = (
            np.zeros((blocks, tns_meta["order"], ch), np.int8)
            if tns_meta is not None else None
        )
        nfl = (
            np.zeros((blocks, ch), np.uint8)
            if self.meta.get("nf") is not None else None
        )
        bsw = (
            np.zeros(blocks, bool)
            if self.meta.get("bs") is not None else None
        )
        bwe_meta = self.meta.get("bwe")
        bwe = None
        if bwe_meta is not None:
            from audiocodec_tpu import bwe as _bwe_mod

            bwe = np.zeros(
                (blocks, _bwe_mod.n_groups(n, bwe_meta["start"]), ch),
                np.uint8,
            )
        is_meta = self.meta.get("isf")
        isg = None
        if is_meta is not None:
            from audiocodec_tpu import intensity as _is_mod

            isg = np.zeros(
                (blocks, _is_mod.n_groups(n, is_meta["start"])), np.uint8
            )
        return Chunk(codes, bark, tns, nfl, None, bsw, bwe, isg, None,
                     silent=levels)

    def close(self) -> None:
        if self._owns_file:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def modal_body_blocks(reader: "StreamReader") -> int:
    """The stream's MODAL body-chunk size over readable headers (the
    format writes uniform body chunks + a 1-frame flush). Used by loss
    concealment everywhere a chunk's OWN header cannot be trusted — a
    corrupted u32 must not size a multi-gigabyte synthesis or desync
    the noise fill's frame offsets."""
    seen: dict[int, int] = {}
    for j in range(max(0, reader.n_chunks - 1)):
        try:
            b = reader.chunk_blocks(j)
        except ValueError:
            continue
        if 0 < b <= reader._size:
            seen[b] = seen.get(b, 0) + 1
    return max(seen, key=seen.get) if seen else 1


# -- codec integration ---------------------------------------------------------
#
# The per-chunk device work is jit-compiled (cached on the codec pytree's
# structure + chunk shape): an hour-long CLI encode runs thousands of chunk
# steps, and eager op-by-op dispatch would pay per-op launch overhead on
# each. Chunk shapes are constant across a stream
# (uniform chunks + one flush frame), so each stream costs at most two
# compiles per direction.


def _jit_encode_chunk():
    import functools

    import jax

    from audiocodec_tpu import streaming

    import jax.numpy as jnp

    @functools.partial(
        jax.jit,
        static_argnames=(
            "ms", "deadzone", "tns", "nf", "tmask", "bs", "bwe",
            "intensity", "fec_mult",
        ),
    )
    def step(codec, carry, x_chunk, drown, threshold_scale, ms, deadzone,
             tns=False, nf=False, tmask=0.0, tmask_context=None,
             bs=False, bwe=False, intensity=False, fec_mult=0.0,
             codec_fec=None):
        carry, frames = streaming.mdct_stream_step(
            codec.mdct, carry, x_chunk
        )
        enc = codec.encode_frames(
            frames, drown, threshold_scale=threshold_scale, ms=ms,
            deadzone=deadzone, tns=tns, nf=nf, tmask=tmask,
            tmask_context=tmask_context, bs=bs, bwe=bwe,
            intensity=intensity,
        )
        # FEC redundancy: a PLAIN coarse quantize of the same frames (no
        # feature ladder — the copy must decode standalone out of a
        # successor chunk), riding the same device program. codec_fec is
        # the same codec on the member's own coarser sidecar grid
        # (_FEC_K2) and the quantize pools the sidecar over _FEC_TPOOL
        # frames, so the codes are quantized against exactly the sidecar
        # the member transmits — the step-size invariant.
        fecq = None
        if fec_mult:
            cf = codec_fec if codec_fec is not None else codec
            fecq = cf.quantize_frames_fec(
                frames, drown,
                threshold_scale=threshold_scale * fec_mult,
                ms=ms, deadzone=deadzone, tpool=_FEC_TPOOL,
            )
        new_ctx = None
        if tmask:
            # rolling pre-spread Bark context for the NEXT chunk: the
            # trailing window frames' intensities, recomputed from the
            # same frames analyze_for_quantization saw (tonality and the
            # Bark projection are purely per-frame, so this is
            # bit-identical to the values used above)
            w = codec.tmask_context_frames(tmask)
            take = min(w, frames.shape[1])
            pre = codec.bark_intensity(frames[:, -take:], drown)
            if tmask_context is not None and take < w:
                pre = jnp.concatenate(
                    [tmask_context, pre], axis=1
                )[:, -w:]
            new_ctx = pre
        # the EncodedFrames rides through whole: positional re-tupling
        # here is exactly the arity coupling EncodedFrames exists to end
        return carry, new_ctx, enc, fecq

    @functools.partial(
        jax.jit,
        static_argnames=(
            "ms", "deadzone", "tns", "nf", "tmask", "bs", "bwe",
            "intensity",
        ),
    )
    def flush(codec, carry, drown, threshold_scale, ms, deadzone,
              tns=False, nf=False, tmask=0.0, tmask_context=None,
              bs=False, bwe=False, intensity=False):
        last = streaming.mdct_stream_flush(codec.mdct, carry)
        return codec.encode_frames(
            last, drown, threshold_scale=threshold_scale, ms=ms,
            deadzone=deadzone, tns=tns, nf=nf, tmask=tmask,
            tmask_context=tmask_context, bs=bs, bwe=bwe,
            intensity=intensity,
        )

    return step, flush


_ENCODE_CHUNK = None


def _encode_chunk_fns():
    global _ENCODE_CHUNK
    if _ENCODE_CHUNK is None:
        _ENCODE_CHUNK = _jit_encode_chunk()
    return _ENCODE_CHUNK


def encode_stream(codec, x, path: str, chunk_blocks: int = 256,
                  drown=0.0, ms: bool = False,
                  threshold_scale: float = 1.0,
                  deadzone: float = 0.5, tns: bool = False,
                  nf: bool = False, nf_seed: int = 0,
                  tmask: float = 0.0, bs: bool = False,
                  bwe: bool = False, intensity: bool = False,
                  fec: float = 0.0, dtx: float = 0.0,
                  orig_samples: int = 0, lufs=None) -> int:
    """Encode a long waveform to a seekable stream with bounded memory.

    Uses the streaming MDCT (one carried block across chunks) and per-chunk
    masking + quantization against the bfloat16-rounded Bark intensity —
    the same encoder/decoder step-size agreement as .acz, including joint
    mid/side stereo (``ms``) and the stream-global rate-control scale
    (``threshold_scale``), both persisted in the header.

    :param x: [1, samples, channels], samples a multiple of chunk_blocks*N.
    :param threshold_scale: ONE float applies stream-globally (the header
        records it); a SEQUENCE of floats — one per body chunk — writes a
        CBR stream where every chunk carries its own scale on the wire
        (the flush frame reuses the last chunk's). See
        :func:`encode_stream_cbr` for the search that produces them.
    :param deadzone: zero-bin half-width for the quantizer (0.5 = plain
        rounding); its reconstruction offset rides the header as ``dzr``.
    :param tns: temporal noise shaping (tns.py). Per-frame, so chunking
        does not change the filters — a TNS .acs decodes bit-identically
        to the same signal's TNS .acz. Indices ride each chunk.
    :param nf: noise filling (nf.py). Levels are per-frame and the
        decoder's fill noise is keyed by GLOBAL frame index, so an nf
        .acs decodes bit-identically to the same signal's nf .acz
        (same ``nf_seed``), including mid-stream seeks.
    :param bs: block switching (blockswitch.py). Detection is a pure
        per-frame function of the spectrum, so chunk flags are
        bit-identical to a whole-file encode's and ride each chunk as a
        bitmap.
    :param bwe: bandwidth extension (bwe.py). Gains are a pure per-frame
        function of (codes, steps, spectrum) with a static copy-up map,
        so a bwe .acs decodes bit-identically to the same signal's bwe
        .acz, including mid-stream seeks. Gains ride each chunk; the
        crossover rides the header.
    :param tmask: forward (post-)masking decay in dB/s, 0 = off (see
        psycho.temporal_masking). Encoder-side only — it raises the
        Bark sidecar before rounding, so nothing rides the header. A
        rolling context of pre-spread intensities is carried across
        chunks, making the .acs bit-identical to the same signal's
        tmask .acz.
    :param intensity: intensity stereo (intensity.py, requires ``ms``).
        Gains are a pure per-frame function of (codes, steps,
        spectrum), so an intensity .acs decodes bit-identically to the
        same signal's intensity .acz, including mid-stream seeks. Gains
        ride each chunk; the crossover rides the header.
    :param fec: forward error correction, 0 = off. When > 0 (a
        threshold-scale MULTIPLIER, e.g. 4.0), every chunk additionally
        carries a coarse plain-quantized redundant copy of the PREVIOUS
        chunk — the Opus-LBRR pattern — so
        :func:`decode_stream(conceal=True)` rebuilds a lost chunk from
        real spectral data out of its successor instead of
        extrapolating. Costs extra bytes (shrinking as ``fec`` grows);
        only the final flush chunk (one frame) is unprotected.
    :param dtx: discontinuous transmission gate in dBFS (negative,
        e.g. -70.0), 0 = off. Chunks whose per-channel RMS all sit below
        the gate — with a one-chunk hangover after active content — are
        written as ~(9+4C)-byte silent records carrying a per-channel
        comfort-noise RMS level; the decoder synthesizes flat noise at
        that level (digital-silence chunks decode to true silence).
        The encoder zeroes its MDCT carry across gated chunks, so both
        ends agree the gated span is silence and the window overlap
        crossfades the boundaries. Bumps the stream magic to ACS3
        (pre-DTX readers refuse loudly); does not compose with ``fec``
        or per-chunk CBR scales. Gating is a user policy knob — the
        psychoacoustic model itself would faithfully code a -80 dBFS
        noise floor at ~70 kbit/s (it sits above threshold-in-quiet at
        the 120 dB SPL calibration); DTX is how a caller says that
        content is not worth bits.
    :return: number of chunks written.
    """
    import jax.numpy as jnp

    from audiocodec_tpu import streaming
    from audiocodec_tpu import tns as _tns_mod

    from audiocodec_tpu.utils import dtypes as _dtypes

    mdct = codec.mdct
    n = mdct.filters_n
    # dtype check BEFORE the device commit: jnp.asarray would silently
    # canonicalize e.g. float64 -> float32, defeating the framework-wide
    # no-implicit-casting contract this function previously enforced
    _dtypes.check_input_dtype(x, mdct.compute_dtype, "encode_stream input")
    # Commit the signal to the device ONCE: chunk slices of a host numpy
    # array would otherwise each pay jit's implicit host transfer.
    x = jnp.asarray(x)
    b, s, c = x.shape
    if b != 1:
        raise ValueError("encode_stream takes a single clip")
    if ms and c != 2:
        raise ValueError("joint mid/side coding needs a stereo input")
    chunk = chunk_blocks * n
    if s % chunk != 0:
        raise ValueError(f"samples {s} must be a multiple of {chunk}")

    from audiocodec_tpu import quantize as _quantize

    deadzone = float(deadzone)
    dz_recon = (
        _quantize.dz_recon_offset(deadzone) if deadzone != 0.5 else 0.0
    )
    cbr = np.ndim(threshold_scale) > 0 or isinstance(
        threshold_scale, (list, tuple)
    )
    if cbr:
        scales = [float(v) for v in np.asarray(threshold_scale).ravel()]
        if len(scales) != s // chunk:
            raise ValueError(
                f"per-chunk threshold_scale needs one value per body "
                f"chunk ({s // chunk}), got {len(scales)}"
            )
    with StreamWriter(
        path,
        sample_rate=codec.psycho.sample_rate,
        filters_n=n,
        bark_bands_n=codec.psycho.bark_bands_n,
        alpha=codec.psycho.alpha,
        window_type=mdct.window_type,
        channels=c,
        compute_dtype=str(jnp.dtype(mdct.compute_dtype)),
        ms=ms,
        threshold_scale=1.0 if cbr else threshold_scale,
        bark_precision=codec.psycho.bark_precision,
        dz_recon=dz_recon,
        tns_order=_tns_mod.ORDER if tns else 0,
        tns_band_start=codec.tns_band_start if tns else 0,
        nf=nf,
        nf_band_start=codec.nf_band_start if nf else 0,
        nf_seed=nf_seed if nf else 0,
        cbr=cbr,
        bs=bs,
        bwe_start=codec.bwe_start if bwe else 0,
        is_start=codec.is_start if intensity else 0,
        sidecar_grid=codec.sidecar_grid,
        fec_scale=float(fec),
        dtx_level=float(dtx),
        orig_samples=orig_samples,
        lufs=lufs,
    ) as w:
        step, flush = _encode_chunk_fns()
        carry = streaming.mdct_stream_init(mdct, 1, c)
        gate = None
        if dtx:
            # one jitted device pass (not eager op-by-op dispatch):
            # per-(chunk, channel) RMS of the input. The gate compares
            # the LOUDEST channel; a one-chunk hangover keeps coding
            # through the chunk right after active content so decays
            # are not clipped mid-ring.
            import jax as _jax

            rms = np.asarray(
                _jax.jit(
                    lambda v: jnp.sqrt(
                        jnp.mean(
                            v.astype(jnp.float32).reshape(
                                s // chunk, chunk, c
                            ) ** 2,
                            axis=1,
                        )
                    )
                )(x)
            )
            thr = 10.0 ** (float(dtx) / 20.0)
            below = rms.max(axis=1) < thr
            gate = below & np.roll(below, 1)
            gate[0] = below[0]
            levels = rms  # comfort-noise levels = the gated content's RMS
        # one-deep software pipeline: dispatch chunk k+1 (async on the
        # device) BEFORE the host blocks on packing chunk k, so Rice
        # coding and device compute overlap instead of strictly
        # alternating. Append order is unchanged.
        pending = None
        tmask = float(tmask)
        tctx = None
        fec = float(fec)
        codec_fec = None
        if fec:
            import dataclasses

            # same codec on the FEC member's own coarse sidecar grid:
            # the copy's codes must be quantized against the snapped
            # sidecar the member transmits (step-size invariant)
            codec_fec = dataclasses.replace(codec, sidecar_grid=_FEC_K2)
        # chunk k's FEC member is packed from chunk k-1's coarse
        # quantize; the arrays stay DEVICE-resident until pack time so
        # the host fetch rides the same one-deep pipeline as the codes
        prev_coarse = None
        for k, start in enumerate(range(0, s, chunk)):
            ts_k = scales[k] if cbr else threshold_scale
            if gate is not None and gate[k]:
                if pending is not None:
                    w.append(*pending)
                    pending = None
                # digital silence records level 0 -> decode to silence
                lv = levels[k] * (levels[k] > 1e-12)
                w.append_silent(chunk_blocks, lv)
                # both ends treat the gated span as zeros: reset the
                # overlap carry (what an all-zero chunk would leave) and
                # drop the post-masking context (>=1 gated chunk of
                # decay leaves nothing audible; a fresh context only
                # LOWERS thresholds, the conservative direction)
                carry = streaming.mdct_stream_init(mdct, 1, c)
                tctx = None
                continue
            carry, tctx, enc, fecq = step(
                codec, carry, x[:, start : start + chunk], drown,
                ts_k, ms, deadzone, tns, nf, tmask=tmask,
                tmask_context=tctx, bs=bs, bwe=bwe, intensity=intensity,
                fec_mult=fec, codec_fec=codec_fec,
            )
            if pending is not None:
                w.append(*pending)
            fec_bytes = None
            if fec:
                fec_bytes = (
                    b"" if prev_coarse is None
                    else pack_fec_member(*prev_coarse, w.meta)
                )
                prev_coarse = (fecq[0], fecq[1], ts_k * fec)
            pending = (enc.codes, enc.bark16, enc.tns_idx,
                       enc.nf_levels, ts_k if cbr else None,
                       enc.bs_flags, enc.bwe_gains, enc.is_gains,
                       fec_bytes)
        if pending is not None:
            w.append(*pending)
        ts_last = scales[-1] if cbr else threshold_scale
        last = flush(codec, carry, drown, ts_last, ms, deadzone,
                     tns, nf, tmask=tmask, tmask_context=tctx, bs=bs,
                     bwe=bwe, intensity=intensity)
        fec_last = None
        if fec:
            # the flush chunk (one frame, never protected itself)
            # carries the LAST body chunk's redundancy
            fec_last = (
                b"" if prev_coarse is None
                else pack_fec_member(*prev_coarse, w.meta)
            )
        w.append(last.codes, last.bark16, last.tns_idx, last.nf_levels,
                 tscale=ts_last if cbr else None,
                 bs_flags=last.bs_flags, bwe_gains=last.bwe_gains,
                 is_gains=last.is_gains, fec=fec_last)
        n_chunks = len(w._index)
    return n_chunks


def encode_stream_with_target_bitrate(
    codec, x, path: str, chunk_blocks: int = 256, *,
    target_kbps: float, drown=0.0, ms: bool = False,
    sample_chunks: int = 8, tolerance: float = 0.08,
    log2_scale_range=(-4.0, 10.0), deadzone="auto", tns: bool = False,
    nf: bool = False, tmask: float = 0.0, bs: bool = False,
    bwe: bool = False, intensity: bool = False, fec: float = 0.0,
    orig_samples: int = 0, lufs=None,
):
    """Rate-controlled stream encode: pick ONE stream-global threshold
    scale from a strided sample of the signal (the vmapped trial search of
    rate.py), then stream-encode everything with it. The scale rides the
    header, so the decoder honors it chunk by chunk.

    Hour-long inputs never pay full-length rate trials — only the sampled
    chunks are searched. The sampler targets the payload budget (the
    stream's fixed framing overhead is known beforehand and subtracted);
    if content drift still leaves the measured rate off by more than
    ``tolerance``, up to THREE corrective re-encodes run with the scale
    adjusted along the measured size/scale curve (plus one final
    best-restore re-encode if the last attempt was not the closest), so
    the worst case is five full streaming passes. The returned kbps is
    the actual file's.

    :return: (n_chunks, threshold_scale, measured_kbps).
    """
    import os

    import jax.numpy as jnp
    import numpy as np

    from audiocodec_tpu import rate as _rate

    n = codec.mdct.filters_n
    chunk = chunk_blocks * n
    s = x.shape[1]
    seconds = s / codec.psycho.sample_rate
    n_chunks_est = s // chunk + 1  # + flush chunk
    # fixed framing: magic+header, per-chunk 16 B, index 8 B/chunk, trailer
    overhead_bytes = 300 + 24 * n_chunks_est + 16
    overhead_kbps = overhead_bytes * 8 / seconds / 1000
    payload_target = max(0.5, target_kbps - overhead_kbps)

    take = min(max(1, sample_chunks), max(1, s // chunk))
    starts = np.linspace(0, s // chunk - 1, take).astype(int) * chunk
    sample = jnp.concatenate(
        [x[:, st : st + chunk] for st in starts], axis=1
    )

    # one dead-zone for the sampled search, every full pass, and the
    # header — trials and the shipped stream must quantize identically
    z = _rate.resolve_deadzone(
        deadzone, target_kbps, x.shape[-1], codec.psycho.sample_rate
    )

    def search(tgt):
        # the sampled search only picks a scale; fill levels don't change
        # the rate curve (~1 deflated byte/frame), so trials skip them.
        # BWE gains DO (rate.py packs them per trial when bwe is set).
        return _rate.encode_with_target_bitrate(
            codec, sample, tgt, drown=drown, ms=ms, deadzone=z, tns=tns,
            tmask=tmask, bs=bs, bwe=bwe, intensity=intensity,
        ).threshold_scale

    def full_encode(scale):
        # fec rides every full pass, so the secant loop's measured kbps
        # INCLUDES the redundancy bytes — the target is hit fec and all
        n_chunks = encode_stream(
            codec, x, path, chunk_blocks=chunk_blocks, drown=drown, ms=ms,
            threshold_scale=scale, deadzone=z, tns=tns, nf=nf,
            tmask=tmask, bs=bs, bwe=bwe, intensity=intensity, fec=fec,
            orig_samples=orig_samples, lufs=lufs,
        )
        return n_chunks, os.path.getsize(path) * 8 / seconds / 1000

    # First scale from the sampled curve, then (only if off-target) secant
    # iterations on the ACTUAL stream: payload bits are locally linear in
    # log2(scale), so two stream points nail the next scale. The sampled
    # curve alone under-counts the chunked sidecar (deltas restart per
    # chunk), which is exactly the bias the secant removes.
    scale = search(payload_target)
    n_chunks, kbps = full_encode(scale)
    attempts = [(scale, kbps, n_chunks)]
    while (
        abs(kbps - target_kbps) > tolerance * target_kbps
        and len(attempts) < 4
    ):
        payload = max(kbps - overhead_kbps, 0.25)
        want = max(target_kbps - overhead_kbps, 0.25)
        if len(attempts) == 1:
            # one-point correction via the sampled curve's local shape
            scale = search(max(0.5, payload_target * want / payload))
        else:
            (s1, k1, _), (s2, k2, _) = attempts[-2], attempts[-1]
            p1 = max(k1 - overhead_kbps, 0.25)
            p2 = max(k2 - overhead_kbps, 0.25)
            if abs(np.log(p2 / p1)) < 1e-6:
                break  # at the entropy floor; no scale can help
            slope = (np.log2(s2) - np.log2(s1)) / np.log(p2 / p1)
            scale = float(
                2.0 ** (np.log2(s2) + slope * np.log(want / p2))
            )
            scale = min(max(scale, 2.0 ** log2_scale_range[0]),
                        2.0 ** log2_scale_range[1])
        n_chunks, kbps = full_encode(scale)
        attempts.append((scale, kbps, n_chunks))

    best = min(attempts, key=lambda a: abs(a[1] - target_kbps))
    if best is not attempts[-1]:
        scale = best[0]
        n_chunks, kbps = full_encode(scale)
    else:
        scale, kbps, n_chunks = best
    return n_chunks, scale, kbps


def encode_stream_cbr(
    codec, x, path: str, chunk_blocks: int = 256, *,
    target_kbps: float, drown=0.0, ms: bool = False,
    tolerance: float = 0.05, trials_per_round: int = 8,
    deadzone="auto", tns: bool = False, nf: bool = False,
    tmask: float = 0.0, bs: bool = False, bwe: bool = False,
    intensity: bool = False, fec: float = 0.0,
    orig_samples: int = 0, lufs=None, reservoir_kbits: float = 0.0,
):
    """Constant-bitrate stream encode: EVERY chunk is rate-controlled to
    its per-chunk share of the target in ONE vmapped batch search (each
    chunk is a clip of rate.encode_with_target_bitrate_batch — the whole
    stream's trials are two or three device passes regardless of
    length), then the stream is written with per-chunk scales on the
    wire (the ``cbr`` format). Unlike the stream-global search
    (:func:`encode_stream_with_target_bitrate` — ABR), the local rate
    cannot drift with content: a loud chorus and a quiet verse spend the
    same bits per second, trading VBR's global quality allocation for
    transport-bounded chunks.

    ``reservoir_kbits > 0`` turns on the bit reservoir (the MP3/AAC
    pattern): one ABR pass measures each chunk's bit demand at uniform
    quality, :func:`audiocodec_tpu.rate.reservoir_allocate` redistributes
    the budget toward hard chunks under a hard ``±reservoir_kbits``
    bound on the running deviation from the constant-rate schedule, and
    the per-chunk search then converges each chunk to ITS OWN target.
    The wire format is unchanged (per-chunk scales); only the allocation
    moves. ``reservoir → 0`` is plain CBR, ``reservoir → ∞`` is ABR's
    allocation with CBR's per-chunk convergence.

    The search encodes each chunk as an INDEPENDENT clip; the shipped
    stream uses the streaming MDCT (one carried boundary frame), so a
    chunk's final size can differ from its searched size by roughly one
    frame's worth of codes — within ``tolerance`` for real chunk sizes.

    :return: (n_chunks, per-chunk scales list, measured whole-file kbps).
    """
    import os

    import jax.numpy as jnp

    from audiocodec_tpu import rate as _rate

    n = codec.mdct.filters_n
    chunk = chunk_blocks * n
    b, s, c = x.shape
    if b != 1:
        raise ValueError("encode_stream_cbr takes a single clip")
    if s % chunk != 0 or s == 0:
        raise ValueError(f"samples {s} must be a multiple of {chunk}")
    n_body = s // chunk
    sr = codec.psycho.sample_rate
    chunk_seconds = chunk / sr
    # fixed per-chunk framing: 8 B scale + 16 B headers/CRC + 8 B index
    # (+4 B per optional member length), plus the stream header amortized
    overhead_bytes = (
        32 + (4 if tns else 0) + (4 if nf else 0) + (4 if bwe else 0)
        + (4 if intensity else 0)
    )
    overhead_kbps = (overhead_bytes + 350 / max(n_body, 1)) * 8 / (
        chunk_seconds * 1000
    )
    payload_target = max(0.5, target_kbps - overhead_kbps)

    z = _rate.resolve_deadzone(deadzone, target_kbps, c, sr)
    chunks_x = jnp.reshape(x[0], (n_body, chunk, c))
    # the search measures packed .acz sizes whose FIXED container
    # overhead (~350 B of meta members) is enormous relative to a
    # sub-second chunk; measure it once with an all-zero pack of the
    # right shape and aim the search above the payload target by
    # exactly that, or every chunk lands systematically coarse
    import numpy as _np

    from audiocodec_tpu.io import bitstream as _bitstream

    import ml_dtypes

    blocks_per_clip = chunk_blocks + 1
    empty = _bitstream.pack(
        _np.zeros((1, blocks_per_clip, n, c), _np.int32),
        _np.zeros(
            (1, blocks_per_clip, codec.psycho.bark_bands_n,
             1 if ms else c), ml_dtypes.bfloat16,
        ),
        sample_rate=sr, filters_n=n,
        bark_bands_n=codec.psycho.bark_bands_n,
        alpha=codec.psycho.alpha, window_type=codec.mdct.window_type,
        ms=ms,
    )
    acz_overhead_kbps = len(empty) * 8 / chunk_seconds / 1000

    def search_and_encode(clip_targets):
        # the clip measurements carry a fixed container overhead the
        # stream never ships; `tolerance` is a payload-relative contract,
        # so shrink the clip-space tolerance by the payload fraction or
        # the search exits rounds early with payload-sized error bars
        tol_clip = max(
            2e-3,
            tolerance * payload_target
            / (payload_target + acz_overhead_kbps),
        )
        results = _rate.encode_with_target_bitrate_batch(
            codec, chunks_x, clip_targets,
            drown=drown, tolerance=tol_clip,
            trials_per_round=trials_per_round,
            ms=ms, deadzone=z, tns=tns, tmask=tmask, bs=bs, bwe=bwe,
            intensity=intensity,
        )
        sc_list = [r.threshold_scale for r in results]
        n_ch = encode_stream(
            codec, x, path, chunk_blocks=chunk_blocks, drown=drown, ms=ms,
            threshold_scale=sc_list, deadzone=z, tns=tns, nf=nf,
            tmask=tmask, bs=bs, bwe=bwe, intensity=intensity, fec=fec,
            orig_samples=orig_samples, lufs=lufs,
        )
        kbps_out = os.path.getsize(path) * 8 / (s / sr) / 1000
        chosen = _np.array([r.kbps for r in results])
        return n_ch, sc_list, kbps_out, chosen

    demand_bits = None
    if reservoir_kbits < 0 or not _np.isfinite(reservoir_kbits):
        raise ValueError(
            f"reservoir_kbits must be finite and >= 0: {reservoir_kbits}"
        )
    if reservoir_kbits > 0.0 and n_body > 1:
        # Bit reservoir: the demand profile is the per-chunk byte sizes
        # of ONE ABR pass (uniform quality at the same target, same
        # dead zone and feature ladder) read back from the stream index
        # — framing, sidecar, and fec bytes all included, so the
        # allocator redistributes exactly what the wire will carry.
        encode_stream_with_target_bitrate(
            codec, x, path, chunk_blocks=chunk_blocks,
            target_kbps=target_kbps, drown=drown, ms=ms, deadzone=z,
            tns=tns, nf=nf, tmask=tmask, bs=bs, bwe=bwe,
            intensity=intensity, fec=fec,
        )
        with StreamReader(path) as r:
            demand_bits = _np.array(
                [r.chunk_bytes(i) * 8.0 for i in range(n_body)]
            )

    budget_bits = payload_target * 1000.0 * chunk_seconds * n_body
    floor_bits = 0.5 * 1000.0 * chunk_seconds

    # the DESIRED per-chunk wire bits (fixed schedule): equal shares, or
    # the reservoir's demand-weighted split of the same budget — the
    # excursion bound is enforced on this schedule once, up front
    if demand_bits is None:
        desired_bits = _np.full(
            n_body, payload_target * chunk_seconds * 1000.0
        )
    else:
        # reservoir_allocate enforces floor_bits itself (its waterfill
        # clamps every chunk to >= floor) — the floor contract lives there
        desired_bits = _rate.reservoir_allocate(
            demand_bits, budget_bits, reservoir_kbits * 1000.0,
            floor=floor_bits,
        )
    want_wire = desired_bits + overhead_bytes * 8.0

    def read_wire():
        with StreamReader(path) as r:
            return _np.array(
                [r.chunk_bytes(i) * 8.0 for i in range(n_body)]
            )

    # first pass aims each chunk's clip search at its desired payload
    # plus the measured empty-container overhead; then up to four
    # corrective re-searches close the clip→stream systematic bias (the
    # trials measure independent .acz clips whose fixed overhead and
    # sidecar bytes differ from the shipped streaming chunks) by working
    # in MEASURED space. The wire size is AFFINE in the clip size (both
    # carry a large fixed floor: sidecar bytes, zero-run codes), so a
    # proportional rescale alone over- or under-shoots; per chunk we run
    # a secant on the two most recent measured (achieved clip kbps →
    # wire bits) points, with a ratio step when only one distinct point
    # exists (e.g. pass 1 pinned every chunk at maximum coarseness).
    clip0 = _np.maximum(
        0.5, desired_bits / (chunk_seconds * 1000.0)
    ) + acz_overhead_kbps
    n_chunks, scales, kbps, chosen = search_and_encode(clip0)
    best = (abs(kbps - target_kbps), n_chunks, scales, kbps)
    prev_pt = None
    for _ in range(4):
        if abs(kbps - target_kbps) <= tolerance * target_kbps:
            break
        actual = read_wire()
        nxt = _np.empty(n_body)
        for i in range(n_body):
            if (
                prev_pt is not None
                and abs(actual[i] - prev_pt[1][i]) > 1e-6
                and abs(chosen[i] - prev_pt[0][i]) > 1e-9
            ):
                slope = (chosen[i] - prev_pt[0][i]) / (
                    actual[i] - prev_pt[1][i]
                )
                step = (want_wire[i] - actual[i]) * slope
                # a negative secant slope is measurement noise (size is
                # monotone in rate) — fall through to the ratio step
                if slope > 0:
                    nxt[i] = chosen[i] + _np.clip(
                        step, -0.75 * chosen[i], 4.0 * chosen[i]
                    )
                    continue
            nxt[i] = chosen[i] * _np.clip(
                want_wire[i] / actual[i], 0.25, 8.0
            )
        prev_pt = (chosen.copy(), actual)
        n_chunks, scales, kbps, chosen = search_and_encode(
            _np.maximum(0.5, nxt)
        )
        if abs(kbps - target_kbps) < best[0]:
            best = (abs(kbps - target_kbps), n_chunks, scales, kbps)
    # never return a worse stream than the best pass produced: if a late
    # correction regressed, re-ship the best pass's scales
    if best[0] < abs(kbps - target_kbps):
        _, n_chunks, scales, kbps = best
        encode_stream(
            codec, x, path, chunk_blocks=chunk_blocks, drown=drown,
            ms=ms, threshold_scale=scales, deadzone=z, tns=tns, nf=nf,
            tmask=tmask, bs=bs, bwe=bwe, intensity=intensity, fec=fec,
            orig_samples=orig_samples, lufs=lufs,
        )
    return n_chunks, scales, kbps


def _dequant_frames(codec, codes, bark, tscale, ms, dzr=0.0,
                    tns=None, tns_bs=0,
                    nfl=None, nf_bs=0, nf_seed=0, frame_offset=0,
                    bsw=None, bwe=None, bwe_start=0,
                    isg=None, is_start=0):
    """Mirror EXACTLY the encoder's threshold derivation (ms min-channel
    sidecar, stream-global scale) so step sizes are bit-identical; apply
    the header's dead-zone reconstruction offset ``dzr``, the noise fill
    (``nfl`` levels, keyed by ``frame_offset`` + frame so chunking and
    seeks reproduce the same noise), and — for TNS streams — the inverse
    noise-shaping filter (in the coded domain, before any mid/side
    derotation, mirroring the encoder)."""
    import jax.numpy as jnp

    from audiocodec_tpu import nf as _nf_mod
    from audiocodec_tpu import quantize as _quantize
    from audiocodec_tpu import tns as _tns_mod

    dtype = codec.mdct.compute_dtype
    if ms:
        threshold = codec._ms_threshold(jnp.asarray(bark)[None])
    else:
        threshold = codec.psycho.bark_intensity_to_threshold(
            jnp.asarray(bark, dtype=dtype)[None]
        )
    threshold = threshold * jnp.asarray(tscale, dtype=dtype)
    if tns is not None:
        tns = jnp.asarray(tns)[None]
        threshold = _tns_mod.scaled_threshold(threshold, tns, tns_bs)
    if bsw is not None:
        from audiocodec_tpu import blockswitch as _bs_mod

        bsw = jnp.asarray(bsw)[None]
        # pooling LAST, after every scaling — mirrors the encoder
        threshold = _bs_mod.pool_threshold(threshold, bsw)
    delta = _quantize.step_size(threshold)
    codes = jnp.asarray(codes)[None]
    spec = _quantize.dequantize(codes, delta, dtype=dtype, recon_offset=dzr)
    excl = None
    if isg is not None:
        from audiocodec_tpu import intensity as _is_mod

        excl = jnp.asarray(
            _is_mod.owned_mask(codec.mdct.filters_n, is_start)
        )
    if bwe is not None:
        from audiocodec_tpu import bwe as _bwe_mod

        # copy-up BEFORE the noise fill (which it caps at the crossover)
        # and the TNS inverse — mirroring Codec.decode_bitstream
        spec = _bwe_mod.fill(
            spec, codes, delta, jnp.asarray(bwe)[None], bwe_start,
            exclude=excl,
        )
    if nfl is not None:
        spec = _nf_mod.fill(
            spec, codes, delta, jnp.asarray(nfl)[None], nf_bs, nf_seed,
            frame_offset,
            band_end=bwe_start if bwe is not None else None,
            exclude=excl,
        )
    if isg is not None:
        from audiocodec_tpu import intensity as _is_mod

        # with bwe active the fill scales the bwe-reconstructed mid —
        # the exact reference the encoder projected onto
        mid_ref = None
        if bwe is not None:
            mid_ref = _is_mod.mid_reference(
                codes, delta, dtype,
                bwe_gains=jnp.asarray(bwe)[None], bwe_start=bwe_start,
                exclude=excl,
            )
        spec = _is_mod.fill(
            spec, codes, delta, jnp.asarray(isg)[None], is_start,
            mid_ref=mid_ref,
        )
    if bsw is not None:
        from audiocodec_tpu import blockswitch as _bs_mod

        spec = _bs_mod.merge_spectrum(
            spec, bsw, precision=codec.mdct.dct_precision
        )
    if tns is not None:
        spec = _tns_mod.filter_inverse(spec, tns, tns_bs)
    return codec.from_mid_side(spec) if ms else spec


def _jit_decode_chunk():
    import functools

    import jax
    import jax.numpy as jnp

    from audiocodec_tpu import streaming

    @functools.partial(
        jax.jit,
        static_argnames=("ms", "dzr", "tns_bs", "nf_bs", "bwe_start",
                         "is_start"),
    )
    def step(codec, carry, codes, bark, tscale, ms, dzr, tns=None,
             tns_bs=0, nfl=None, nf_bs=0, nf_seed=0, frame_offset=0,
             bsw=None, bwe=None, bwe_start=0, isg=None, is_start=0):
        frames = _dequant_frames(codec, codes, bark, tscale, ms, dzr,
                                 tns, tns_bs, nfl, nf_bs, nf_seed,
                                 frame_offset, bsw, bwe, bwe_start,
                                 isg, is_start)
        carry, samples = streaming.imdct_stream_step(
            codec.mdct, carry, frames
        )
        # last decoded spectral frame rides along (device-resident,
        # [1, 1, N, C]) so loss concealment can extrapolate from it
        return carry, samples, frames[:, -1:]

    @jax.jit
    def conceal_step(codec, carry, prev_frame, decay_pows, chunk_idx):
        """Concealment for an unreadable chunk: repeat the last good
        spectral frame with an exponential energy fade and per-frame
        SIGN scrambling (the AAC-family recipe — the magnitude spectrum
        keeps the timbre, random signs turn a frozen frame's periodic
        buzz into noise with the same envelope, and the fade keeps a
        long outage from ringing on). ``decay_pows`` [blocks] carries
        the per-frame decay so blocks stays static; ``chunk_idx`` keys
        the scramble so repeated losses don't repeat noise."""
        blocks = decay_pows.shape[0]
        key = jax.random.fold_in(jax.random.key(0x9E3779B9), chunk_idx)
        signs = jax.random.rademacher(
            key, (1, blocks) + prev_frame.shape[2:], prev_frame.dtype
        )
        frames = prev_frame * decay_pows[None, :, None, None] * signs
        carry, samples = streaming.imdct_stream_step(
            codec.mdct, carry, frames
        )
        return carry, samples, frames[:, -1:]

    @jax.jit
    def conceal_interp_step(codec, carry, prev_frame, next_frame,
                            weights, chunk_idx):
        """Interpolative concealment: when the NEXT chunk is already in
        hand (the decode read-ahead), synthesize the lost chunk as a
        per-bin ENERGY crossfade between the neighboring good frames —
        sqrt((1-w)·prev² + w·next²) with scrambled signs — so the
        spectral envelope morphs into what actually follows instead of
        fading to silence and slamming back. ``weights`` [blocks] ramps
        0→1 across the lost chunk."""
        blocks = weights.shape[0]
        key = jax.random.fold_in(jax.random.key(0x7F4A7C15), chunk_idx)
        signs = jax.random.rademacher(
            key, (1, blocks) + prev_frame.shape[2:], prev_frame.dtype
        )
        w = weights[None, :, None, None]
        mag = jnp.sqrt(
            (1.0 - w) * jnp.square(prev_frame) + w * jnp.square(next_frame)
        )
        frames = mag * signs
        carry, samples = streaming.imdct_stream_step(
            codec.mdct, carry, frames
        )
        return carry, samples, frames[:, -1:]

    @functools.partial(
        jax.jit,
        static_argnames=("ms", "dzr", "tns_bs", "nf_bs", "bwe_start",
                         "is_start"),
    )
    def first_frame(codec, codes, bark, tscale, ms, dzr, tns=None,
                    tns_bs=0, nfl=None, nf_bs=0, nf_seed=0,
                    frame_offset=0, bsw=None, bwe=None, bwe_start=0,
                    isg=None, is_start=0):
        """First dequantized spectral frame of a chunk — the 'next good
        frame' for interpolative concealment (the chunk itself is
        decoded again on the following iteration)."""
        return _dequant_frames(codec, codes, bark, tscale, ms, dzr,
                               tns, tns_bs, nfl, nf_bs, nf_seed,
                               frame_offset, bsw, bwe, bwe_start,
                               isg, is_start)[:, :1]

    @functools.partial(
        jax.jit,
        static_argnames=("ms", "dzr", "tns_bs", "nf_bs", "bwe_start",
                         "is_start"),
    )
    def seek_carry(codec, codes, bark, tscale, ms, dzr, tns=None,
                   tns_bs=0, nfl=None, nf_bs=0, nf_seed=0,
                   frame_offset=0, bsw=None, bwe=None, bwe_start=0,
                   isg=None, is_start=0):
        """-> (overlap-add carry, previous chunk's last spectral frame).
        The frame rides along so concealment of the chunk right AFTER a
        seek can extrapolate from it instead of from silence."""
        mdct = codec.mdct
        prev = _dequant_frames(codec, codes, bark, tscale, ms, dzr,
                               tns, tns_bs, nfl, nf_bs, nf_seed,
                               frame_offset, bsw, bwe, bwe_start,
                               isg, is_start)[:, -1:]
        yb = jnp.transpose(prev, (0, 3, 1, 2))
        if mdct.dense_inv is not None:
            # dense mode carries the previous RAW spectral frame
            # (imdct_stream_step applies the prev tap itself)
            return yb[:, :, -1], prev
        # sparse mode carries the DCT of the previous frame
        from audiocodec_tpu.ops import dct as _dct

        z = _dct.dct4(
            yb, mdct.dct_mat_inv, fast_bf16=mdct.fast_bf16,
            precision=mdct.inv_precision,
        )
        return z[:, :, -1], prev

    return step, conceal_step, conceal_interp_step, first_frame, seek_carry


_DECODE_CHUNK = None


def _decode_chunk_fns():
    global _DECODE_CHUNK
    if _DECODE_CHUNK is None:
        _DECODE_CHUNK = _jit_decode_chunk()
    return _DECODE_CHUNK


def decode_stream(codec, path: str, start_chunk: int = 0,
                  conceal: bool = False, conceal_decay: float = 0.8):
    """Generator of waveform chunks from an .acs stream (seekable).

    Starting mid-stream only needs the previous chunk's last frame for the
    overlap-add carry; the first yielded chunk is then sample-exact.

    :param conceal: packet-loss concealment — a chunk that fails its CRC
        (or is otherwise unreadable) is synthesized instead of raising.
        On fec streams (see :func:`encode_stream`'s ``fec``) the lost
        chunk is REBUILT from the coarse redundant copy riding its
        successor; otherwise the last good spectral frame repeats with
        an exponential energy fade (``conceal_decay`` per frame) — or an
        energy crossfade into the next good chunk when it is already in
        hand — keeping the stream's length, timbre, and overlap-add
        continuity; decoding recovers exactly at the next good chunk.
        Without it (the default) corruption raises ValueError —
        transport errors should be LOUD unless the caller opted into
        real-time playback semantics.
    """
    from audiocodec_tpu import streaming

    mdct = codec.mdct
    (step, conceal_step, conceal_interp_step, first_frame,
     seek_carry) = _decode_chunk_fns()
    with StreamReader(path) as r:
        ch = r.meta["channels"]
        ms = bool(r.meta.get("ms", False))
        tscale = float(r.meta.get("threshold_scale", 1.0))
        dzr = float(r.meta.get("dzr", 0.0))
        tns_meta = r.meta.get("tns")
        tns_bs = int(tns_meta["band_start"]) if tns_meta else 0
        nf_meta = r.meta.get("nf")
        nf_bs = int(nf_meta["band_start"]) if nf_meta else 0
        # uint32 BEFORE the jit boundary: seeds in [2^31, 2^32) are legal
        # wire values but overflow jit's Python-int argument parsing
        # when x64 is off
        nf_seed = np.uint32(nf_meta["seed"]) if nf_meta else np.uint32(0)
        bwe_meta = r.meta.get("bwe")
        bwe_start = int(bwe_meta["start"]) if bwe_meta else 0
        is_meta = r.meta.get("isf")
        is_start = int(is_meta["start"]) if is_meta else 0
        import jax
        import jax.numpy as jnp

        def put_opt(t):
            return None if t is None else jax.device_put(t)

        n = r.meta["filters_n"]
        dtype = mdct.compute_dtype
        prev_frame = jnp.zeros((1, 1, n, ch), dtype)

        _modal_cache = []

        def _body_blocks():
            if not _modal_cache:
                _modal_cache.append(modal_body_blocks(r))
            return _modal_cache[0]

        def chunk_blocks_guess(i):
            """Frame count to conceal for an unreadable chunk i: the
            modal body size, or 1 for the flush chunk (always a single
            frame by construction)."""
            if i == r.n_chunks - 1:
                return 1
            return _body_blocks()

        # global frame index of each chunk's first frame: the noise fill
        # is keyed by it so mid-stream entry reproduces the exact noise.
        # Under conceal the headers are untrusted (a header read alone
        # cannot be CRC-verified), so the prefix sum uses the modal body
        # size; without conceal, unreadable headers raise as usual.
        frame_off = 0
        if nf_meta and start_chunk:
            if conceal:
                frame_off = start_chunk * _body_blocks()
            else:
                frame_off = sum(
                    r.chunk_blocks(j) for j in range(start_chunk)
                )
        carry = streaming.imdct_stream_init(mdct, 1, ch)
        # One-deep read-ahead: host-side chunk parsing (Rice decode +
        # CRC) of chunk i+1 runs in a worker thread while the device
        # works on chunk i. The reader's file handle is shared, so every
        # file access (including the error-path header probes) holds one
        # lock.
        import threading
        from concurrent.futures import ThreadPoolExecutor

        io_lock = threading.Lock()

        def fetch(i):
            try:
                with io_lock:
                    return ("ok", r.read_chunk(i))
            except ValueError as e:
                return ("err", e)

        if start_chunk > 0:
            status, val = fetch(start_chunk - 1)
            if status == "err" and not conceal:
                raise val
            if status == "ok":
                c = val
                prev_off = frame_off - c.codes.shape[0]
                carry, prev_frame = seek_carry(
                    codec, jax.device_put(c.codes), jax.device_put(c.bark),
                    tscale if c.tscale is None else c.tscale,
                    ms, dzr, put_opt(c.tns), tns_bs,
                    put_opt(c.nfl), nf_bs, nf_seed, prev_off,
                    bsw=put_opt(c.bsw), bwe=put_opt(c.bwe),
                    bwe_start=bwe_start,
                    isg=put_opt(c.isg), is_start=is_start,
                )
            # else: prime with silence; recovery at start_chunk
        ex = ThreadPoolExecutor(max_workers=1)
        try:
            fut = ex.submit(fetch, start_chunk) if (
                start_chunk < r.n_chunks
            ) else None
            for i in range(start_chunk, r.n_chunks):
                status, val = fut.result()
                if i + 1 < r.n_chunks:
                    fut = ex.submit(fetch, i + 1)
                if status == "err":
                    if not conceal:
                        raise val
                    with io_lock:
                        blocks = chunk_blocks_guess(i)
                    nxt = None
                    if i + 1 < r.n_chunks:
                        n_status, n_val = fut.result()  # peek read-ahead
                        if n_status == "ok":
                            nxt = n_val
                    # FEC first: the successor chunk carries a coarse
                    # redundant coding of THIS chunk (see pack_fec_member)
                    # — real spectral data beats any extrapolation. The
                    # copy is plain-quantized (no feature ladder), so it
                    # decodes through the standard step with features off.
                    fdec = None
                    if nxt is not None and nxt.fec is not None:
                        try:
                            fdec = parse_fec_member(nxt.fec, r.meta)
                        except ValueError:
                            fdec = None  # version skew/garbage: fall back
                    if fdec is not None:
                        fcodes, fbark, fscale = fdec
                        carry, samples, prev_frame = step(
                            codec, carry, jax.device_put(fcodes),
                            jax.device_put(fbark), fscale, ms, dzr,
                            None, 0, None, 0, nf_seed, frame_off,
                        )
                        frame_off += fcodes.shape[0]
                        yield samples
                        continue
                    if nxt is not None:
                        # both neighbors in hand: morph the spectral
                        # envelope into what actually follows instead of
                        # fading to silence and slamming back
                        nfr = first_frame(
                            codec, jax.device_put(nxt.codes),
                            jax.device_put(nxt.bark),
                            tscale if nxt.tscale is None else nxt.tscale,
                            ms, dzr, put_opt(nxt.tns), tns_bs,
                            put_opt(nxt.nfl), nf_bs, nf_seed,
                            frame_off + blocks,
                            bsw=put_opt(nxt.bsw), bwe=put_opt(nxt.bwe),
                            bwe_start=bwe_start,
                            isg=put_opt(nxt.isg), is_start=is_start,
                        )
                        weights = jnp.asarray(
                            np.arange(1, blocks + 1) / (blocks + 1), dtype
                        )
                        carry, samples, prev_frame = conceal_interp_step(
                            codec, carry, prev_frame, nfr, weights, i
                        )
                    else:
                        decay_pows = jnp.asarray(
                            conceal_decay ** np.arange(1, blocks + 1),
                            dtype,
                        )
                        carry, samples, prev_frame = conceal_step(
                            codec, carry, prev_frame, decay_pows, i
                        )
                    frame_off += blocks
                    yield samples
                    continue
                c = val
                # explicit puts rather than jit's implicit numpy
                # transfer; the CBR per-chunk scale is a traced scalar (no recompiles)
                carry, samples, prev_frame = step(
                    codec, carry, jax.device_put(c.codes),
                    jax.device_put(c.bark),
                    tscale if c.tscale is None else c.tscale,
                    ms, dzr, put_opt(c.tns), tns_bs,
                    put_opt(c.nfl), nf_bs, nf_seed, frame_off,
                    bsw=put_opt(c.bsw), bwe=put_opt(c.bwe),
                    bwe_start=bwe_start,
                    isg=put_opt(c.isg), is_start=is_start,
                )
                if c.silent is not None and float(np.max(c.silent)) > 0:
                    # DTX comfort noise: flat Gaussian at the recorded
                    # per-channel RMS, keyed by chunk index so seeks
                    # reproduce it exactly. Added AFTER the synthesis
                    # step — the (zero-spectrum) step still ran, so the
                    # previous chunk's window tail rings out and the
                    # overlap carry stays on the coded-chunk machinery.
                    cn = np.random.default_rng(0xD7C0FFEE + i)
                    noise = (
                        cn.standard_normal(
                            (1, samples.shape[1], ch)
                        ).astype(np.float32)
                        * c.silent[None, None, :]
                    )
                    samples = samples + jnp.asarray(noise, dtype)
                frame_off += c.codes.shape[0]
                yield samples
            tail = streaming.imdct_stream_flush(mdct, carry)
            yield tail
        finally:
            ex.shutdown(wait=False)
