"""Model-server-style codec serving with dynamic batching.

The reference is a library with no deployment story; a production codec
on an accelerator wants one process owning the card and many clients
feeding it — per-request dispatch would waste it (a single clip encode
uses a sliver of the device and the dispatch/transfer overhead
dominates).
This server applies the standard accelerator-serving recipe, shaped by
XLA's compilation model:

* **Dynamic batching**: concurrent encode requests are grouped (up to
  ``max_batch``, waiting at most ``max_wait_ms`` for stragglers) and run
  as ONE jitted batched call — the same program a benchmark would run.
* **Shape bucketing**: XLA compiles one program per shape, so arbitrary
  clip lengths would mean unbounded recompiles. Clips pad up to the next
  power-of-two MDCT block count and batches pad to power-of-two size:
  the compile universe is log(len) x log(batch) programs, all cached
  (in-process AND in JAX's persistent compilation cache).
* **Exact results despite padding**: an MDCT frame i depends only on
  blocks i-1 and i, and pad blocks are zeros — so trimming the batched
  codes to each clip's real ``blocks+1`` frames is BIT-IDENTICAL to
  encoding the unpadded clip alone through the same jitted program
  (tested). (Caveat: a DIFFERENT lowering of the encoder — e.g. eager
  per-op dispatch — can legitimately differ by ±1 code at rounding
  boundaries; decode is unaffected because step sizes derive from the
  sidecar, never by re-running the encoder's float chain.)
* **Host/device overlap**: Rice-packing of containers happens in a host
  thread pool while the device works on the next batch.

Protocol (length-prefixed binary over TCP or a Unix socket):

  request:  1-byte opcode | u32 big-endian length | payload
  response: 1-byte status (0=ok, 1=error) | u32 length | payload

  opcode 'E': payload = WAV bytes       -> .acz container bytes
  opcode 'D': payload = .acz bytes      -> WAV (16-bit PCM) bytes
  opcode 'Q': payload ignored           -> JSON stats line

Streaming sessions (connection-scoped, low-latency — bypass the batch
queue; at most one active session per connection):

  opcode 'B': payload = JSON config {channels, chunk_blocks,
              threshold_scale, ms, deadzone, tns, nf}
                                        -> the exact .acs header bytes
  opcode 'C': payload = one chunk of float32-LE interleaved PCM
              (chunk_blocks * N * channels samples)
                                        -> the exact .acs chunk bytes
  opcode 'F': payload ignored           -> flush chunk + index/trailer

Concatenating the 'B'/'C'/'F' responses IS a valid .acs file — the
session runs the same StreamWriter and jitted streaming-MDCT step as
offline encode_stream, so the bytes are identical to encoding the
concatenated PCM in one call.

The decode mirror (live transcode of chunks arriving off the wire):

  opcode 'J': payload = .acs header bytes -> JSON stream meta
  opcode 'K': payload = one chunk's bytes -> float32-LE PCM
  opcode 'L': payload ignored             -> final overlap-add tail

'K' re-frames each chunk as a one-chunk stream through the same
StreamReader (CRC checks included) and the same jitted step as offline
decode_stream — sample-identical output.

Clients: :func:`request` (one-shot) or :class:`Client` (persistent
connection, many requests, begin_stream/feed/finish_stream).
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from audiocodec_tpu.io import bitstream
from audiocodec_tpu.io import wav as _wav

_HDR = struct.Struct(">BI")
_MAX_PAYLOAD = 1 << 30


def _read_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _read_frame(sock):
    op, length = _HDR.unpack(_read_exact(sock, _HDR.size))
    if length > _MAX_PAYLOAD:
        raise ValueError(f"frame of {length} bytes exceeds the 1 GiB cap")
    return op, _read_exact(sock, length)


def _write_frame(sock, op: int, payload: bytes) -> None:
    sock.sendall(_HDR.pack(op, len(payload)) + payload)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class _Request:
    __slots__ = ("payload", "event", "status", "response")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.status = 1
        self.response = b"server shutdown"

    def finish(self, status: int, response: bytes):
        self.status = status
        self.response = response
        self.event.set()


class CodecServer:
    """Serve one codec configuration over a socket with dynamic batching.

    :param codec: the :class:`~audiocodec_tpu.codec.Codec` to serve.
    :param sample_rate: rate encode requests must arrive at (the codec's
        construction rate); mismatches are rejected with an error frame —
        resampling policy belongs to the client (`resample` CLI).
    :param host/port: TCP endpoint; port 0 picks a free port (see
        ``.port`` after :meth:`start`). ``unix_path`` serves a Unix
        domain socket instead.
    :param max_batch: dynamic batch cap (padded to the next power of 2).
    :param max_wait_ms: how long the batcher waits for stragglers after
        the first request of a batch arrives.
    :param min_blocks: smallest length bucket, in MDCT blocks.
    :param entropy: container coder for responses. The serving default
        pins "rrice" (when the native library is present): "auto" costs
        BOTH coders post-deflate per request — the right trade for an
        archival file, double the host CPU per response for a server,
        and rrice is within ~1% of auto's size on the content classes
        where they differ.
    """

    def __init__(self, codec, sample_rate: int, host: str = "127.0.0.1",
                 port: int = 0, unix_path: str = "", max_batch: int = 8,
                 max_wait_ms: float = 5.0, min_blocks: int = 8,
                 entropy: str | None = None, inflight_depth: int = 2):
        self._codec = codec
        self._rate = sample_rate
        self._host, self._port0, self._unix = host, port, unix_path
        self._max_batch = max(1, max_batch)
        self._max_wait = max_wait_ms / 1000.0
        self._min_blocks = min_blocks
        self._encode_q: queue.Queue = queue.Queue()
        # batches dispatched-but-unfinalized on the device at once.
        # Depth 2 = one reading back while the next coalesces+uploads
        # (benchmarks/serve_bench.py --inflight-depth probes others).
        self._inflight = threading.Semaphore(max(1, int(inflight_depth)))
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._sock = None
        self.port = None
        self._lock = threading.Lock()
        self.stats = {
            "encode_requests": 0, "encode_batches": 0,
            "decode_requests": 0, "errors": 0,
            "stream_sessions": 0, "stream_chunks": 0,
        }
        # EMA latencies (ms) per op family, alpha=1/16 — enough to spot
        # a regressing path from the 'Q' stats line without a profiler
        self._lat = {}
        n = codec.mdct.filters_n

        @jax.jit
        def _enc(c, x):
            return c.quantize_frames(c.mdct.transform(x))

        import functools

        dtype = codec.mdct.compute_dtype
        bark_n = codec.psycho.bark_bands_n

        @functools.partial(jax.jit, static_argnames=("g", "s", "ch"))
        def _enc_i16(c, flat, g, s, ch):
            """Transport-lean batch encode:

            * IN: the PCM16 batch as ONE flat int16 buffer — half the
              H2D bytes of float32, reshaped on the device;
            * dequant on device: int16/32768 is exact in float32, so
              codes are bit-identical to the float ingress path;
            * OUT: ONE flat int16 buffer [codes:int16 | bark:bf16-bits |
              fits-flag] — half the D2H bytes and a single readback RTT
              instead of two. The flag reports whether every code fit in
              int16; the caller falls back to the int32 path when not
              (loud/low-threshold content, rare).
            """
            x = flat.reshape(g, s, ch).astype(jnp.float32) * jnp.float32(
                1.0 / 32768.0
            )
            codes, bark = c.quantize_frames(c.mdct.transform(x.astype(dtype)))
            fits = (jnp.max(jnp.abs(codes)) <= 32767).astype(jnp.int16)
            b16 = jax.lax.bitcast_convert_type(bark, jnp.int16)
            return jnp.concatenate(
                [codes.astype(jnp.int16).reshape(-1), b16.reshape(-1),
                 fits.reshape(1)]
            )

        self._enc_i16 = _enc_i16
        self._bark_n = bark_n

        @functools.partial(
            jax.jit,
            static_argnames=("ms", "dzr", "tns_bs", "nf_bs", "bwe_start",
                             "is_start"),
        )
        def _dec(c, codes, bark, tscale, ms=False, dzr=0.0,
                 tns=None, tns_bs=0, nfl=None, nf_bs=0, nf_seed=0,
                 bsw=None, bweg=None, bwe_start=0, isg=None, is_start=0):
            # honor EVERY quantization-affecting field a container can
            # record (threshold scale, joint stereo, dead zone, TNS,
            # noise fill, block switching, bandwidth extension) —
            # decoding with defaults silently produces wrong audio
            kw = dict(
                threshold_scale=tscale, dz_recon=dzr, tns_idx=tns,
                tns_band_start=tns_bs or None, nf_levels=nfl,
                # nf band_start 0 is a legal recorded value — pass it
                # verbatim (no falsy-collapse to the codec default)
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

        self._enc, self._dec = _enc, _dec
        if entropy is None:
            from audiocodec_tpu import native as _native

            entropy = "rrice" if _native.available() else "zlib"
        self._meta = dict(
            entropy=entropy,
            sample_rate=sample_rate,
            filters_n=n,
            bark_bands_n=codec.psycho.bark_bands_n,
            alpha=codec.psycho.alpha,
            window_type=codec.mdct.window_type,
            compute_dtype=str(jnp.dtype(codec.mdct.compute_dtype)),
            ms=False,
            bark_precision=codec.psycho.bark_precision,
            sidecar_grid=codec.sidecar_grid,
        )

    # -- lifecycle ---------------------------------------------------

    def _check_container_config(self, meta) -> None:
        """Reject containers/streams whose quantization-affecting config
        differs from the served codec's — dtype and bark_precision are
        step-size-critical and the window shapes the synthesis filter
        bank: a mismatched decode would not error, it would be WRONG."""
        my = self._meta
        mine = (self._rate, self._codec.mdct.filters_n,
                my["bark_bands_n"], my["compute_dtype"],
                my["bark_precision"], my["window_type"])
        theirs = (meta["sample_rate"], meta["filters_n"],
                  meta["bark_bands_n"], meta["compute_dtype"],
                  meta["bark_precision"], meta["window_type"])
        if mine != theirs:
            raise ValueError(
                "container was encoded with a different codec config "
                f"(rate/N/bark/dtype/prec/window {theirs}) than this "
                f"server serves ({mine})"
            )

    def _note_latency(self, kind: str, seconds: float) -> None:
        with self._lock:
            prev = self._lat.get(kind)
            ms = seconds * 1e3
            self._lat[kind] = (
                ms if prev is None else prev + (ms - prev) / 16
            )
            self.stats[f"{kind}_ema_ms"] = round(self._lat[kind], 2)

    def _note_stage(self, kind: str, seconds: float) -> None:
        """Cumulative per-stage wall seconds across the whole batch
        cycle (parse / dispatch / acquire-wait / readback / pack) — the
        request-cycle decomposition serve_bench prints so the gap to
        the transport ceiling is attributed term by term."""
        with self._lock:
            key = f"t_{kind}_s"
            self.stats[key] = round(self.stats.get(key, 0.0) + seconds, 4)

    def start(self):
        if self._unix:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.bind(self._unix)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((self._host, self._port0))
            self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self._sock.settimeout(0.25)
        for fn in (self._accept_loop, self._batch_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._sock is not None:
            self._sock.close()
        # fail any requests still parked in the queue
        while True:
            try:
                self._encode_q.get_nowait().finish(1, b"server shutdown")
            except queue.Empty:
                break

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- connection handling ------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()

    def _serve_conn(self, conn):
        session = None
        dsession = None
        try:
            conn.settimeout(None)
            while not self._stop.is_set():
                try:
                    op, payload = _read_frame(conn)
                except (ConnectionError, OSError):
                    return
                if op == ord("E"):
                    req = _Request(payload)
                    with self._lock:
                        self.stats["encode_requests"] += 1
                    t0 = time.monotonic()
                    self._encode_q.put(req)
                    req.event.wait()
                    self._note_latency("encode", time.monotonic() - t0)
                    _write_frame(conn, req.status, req.response)
                elif op == ord("D"):
                    t0 = time.monotonic()
                    status, resp = self._decode_one(payload)
                    self._note_latency("decode", time.monotonic() - t0)
                    _write_frame(conn, status, resp)
                elif op == ord("B"):
                    if session is not None:
                        _write_frame(
                            conn, 1, b"a stream session is already active"
                        )
                        continue
                    try:
                        session = _StreamSession(self, payload)
                        with self._lock:
                            self.stats["stream_sessions"] += 1
                        _write_frame(conn, 0, session.take_bytes())
                    except Exception as e:  # bad config -> error frame
                        session = None
                        _write_frame(conn, 1, str(e).encode())
                elif op in (ord("C"), ord("A")):
                    if session is None:
                        _write_frame(conn, 1, b"no active stream session")
                        continue
                    try:
                        t0 = time.monotonic()
                        if op == ord("A"):
                            # adaptive feed: 8-byte f64 per-chunk scale
                            # prefix, then the PCM payload (cbr sessions)
                            if len(payload) < 8:
                                raise ValueError(
                                    "adaptive chunk needs an 8-byte "
                                    "scale prefix"
                                )
                            (ts,) = struct.unpack("<d", payload[:8])
                            chunk = session.feed(payload[8:], tscale=ts)
                        else:
                            chunk = session.feed(payload)
                        self._note_latency(
                            "stream_chunk", time.monotonic() - t0
                        )
                        with self._lock:
                            self.stats["stream_chunks"] += 1
                        _write_frame(conn, 0, chunk)
                    except Exception as e:
                        _write_frame(conn, 1, str(e).encode())
                elif op == ord("F"):
                    if session is None:
                        _write_frame(conn, 1, b"no active stream session")
                        continue
                    try:
                        tail = session.finish()
                        session = None
                        _write_frame(conn, 0, tail)
                    except Exception as e:
                        session = None
                        _write_frame(conn, 1, str(e).encode())
                elif op == ord("J"):
                    if dsession is not None:
                        _write_frame(
                            conn, 1, b"a decode session is already active"
                        )
                        continue
                    try:
                        dsession = _DecodeSession(self, payload)
                        with self._lock:
                            self.stats["stream_sessions"] += 1
                        _write_frame(
                            conn, 0, json.dumps(dsession._meta).encode()
                        )
                    except Exception as e:
                        dsession = None
                        _write_frame(conn, 1, str(e).encode())
                elif op == ord("K"):
                    if dsession is None:
                        _write_frame(
                            conn, 1, b"no active decode session"
                        )
                        continue
                    try:
                        t0 = time.monotonic()
                        pcm = dsession.feed(payload)
                        self._note_latency(
                            "stream_chunk", time.monotonic() - t0
                        )
                        with self._lock:
                            self.stats["stream_chunks"] += 1
                        _write_frame(conn, 0, pcm)
                    except Exception as e:
                        _write_frame(conn, 1, str(e).encode())
                elif op == ord("L"):
                    if dsession is None:
                        _write_frame(
                            conn, 1, b"no active decode session"
                        )
                        continue
                    try:
                        pcm = dsession.finish()
                        dsession = None
                        _write_frame(conn, 0, pcm)
                    except Exception as e:
                        dsession = None
                        _write_frame(conn, 1, str(e).encode())
                elif op == ord("Q"):
                    with self._lock:
                        blob = json.dumps(self.stats).encode()
                    _write_frame(conn, 0, blob)
                else:
                    _write_frame(
                        conn, 1, f"unknown opcode {op}".encode()
                    )
        finally:
            conn.close()

    # -- decode path (per-request; containers vary too much to batch) --

    def _decode_one(self, payload):
        try:
            codes, bark, meta = bitstream.unpack(payload)
            self._check_container_config(meta)
            # bucket the frame count (pad with zero frames) so decode
            # compiles O(log len) programs, not one per container length;
            # wave sample k*N..(k+1)*N depends on frames k/k+1 only, so
            # the trimmed region never sees the pad frames (pad TNS rows
            # are identity filters, pad fill levels are 0 = no fill)
            frames = codes.shape[1]
            bucket = max(self._min_blocks + 1, _next_pow2(frames))
            tns = meta["tns_idx"]
            nfl = meta["nf_levels"]
            bsw = meta.get("bs_flags")
            bweg = meta.get("bwe_gains")
            isg = meta.get("is_gains")
            if bucket != frames:
                pad = ((0, 0), (0, bucket - frames), (0, 0), (0, 0))
                codes = np.pad(codes, pad)
                bark = np.pad(np.asarray(bark), pad)
                if tns is not None:
                    tns = np.pad(tns, pad)
                if nfl is not None:
                    nfl = np.pad(nfl, (pad[0], pad[1], pad[3]))
                if bsw is not None:
                    # pad frames stay long (False): identity basis
                    bsw = np.pad(bsw, (pad[0], pad[1]))
                if bweg is not None:
                    # pad gains are 0 = no fill on the zero-code pad rows
                    bweg = np.pad(bweg, pad)
                if isg is not None:
                    # pad gains are 0 = no fill on the zero-code pad rows
                    isg = np.pad(isg, (pad[0], pad[1], pad[2]))
            wave = self._dec(
                self._codec, jnp.asarray(codes),
                jnp.asarray(bark, dtype=jnp.bfloat16),
                meta["threshold_scale"],
                ms=meta["ms"], dzr=meta["dz_recon"],
                tns=None if tns is None else jnp.asarray(tns),
                tns_bs=meta["tns_band_start"],
                nfl=None if nfl is None else jnp.asarray(nfl),
                nf_bs=meta["nf_band_start"],
                # uint32 before the jit boundary: [2^31, 2^32) seeds are
                # legal wire values but overflow jit's int parsing
                nf_seed=np.uint32(meta["nf_seed"]),
                bsw=None if bsw is None else jnp.asarray(bsw),
                bweg=None if bweg is None else jnp.asarray(bweg),
                bwe_start=meta.get("bwe_start", 0),
                isg=None if isg is None else jnp.asarray(isg),
                is_start=meta.get("is_start", 0),
            )
            n = self._codec.mdct.filters_n
            wave = np.asarray(wave.astype(jnp.float32))[
                :, n : n + (frames - 1) * n
            ]
            nsamp = meta.get("orig_samples", 0)
            if nsamp:  # gapless: trim the encoder's tail padding
                wave = wave[:, :nsamp]
            with self._lock:
                self.stats["decode_requests"] += 1
            return 0, _wav.write_wav_bytes(wave[0], self._rate)
        except Exception as e:  # error -> error frame, connection lives
            with self._lock:
                self.stats["errors"] += 1
            return 1, str(e).encode()

    # -- batched encode path -------------------------------------------

    def _batch_loop(self):
        with ThreadPoolExecutor(max_workers=8) as pool:
            while not self._stop.is_set():
                try:
                    first = self._encode_q.get(timeout=0.25)
                except queue.Empty:
                    continue
                batch = [first]
                deadline = time.monotonic() + self._max_wait
                while len(batch) < self._max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        batch.append(self._encode_q.get(timeout=left))
                    except queue.Empty:
                        break
                self._run_batch(batch, pool)

    def _run_batch(self, batch, pool):
        n = self._codec.mdct.filters_n
        dtype = self._codec.mdct.compute_dtype
        t_parse0 = time.monotonic()
        parsed = []  # (req, wave [s, C] int16|f32, real_blocks, samples)
        for req in batch:
            try:
                # PCM16 fast path: raw int16 frames ship to the device
                # as-is (half the H2D bytes; device dequant bit-exact)
                i16 = _wav.read_wav_i16_bytes(req.payload)
                if i16 is not None:
                    wave, rate = i16
                else:
                    wave_f, rate = _wav.read_wav_bytes(req.payload)
                    wave = wave_f[0]
                if rate != self._rate:
                    raise ValueError(
                        f"server encodes at {self._rate} Hz, request is "
                        f"{rate} Hz; resample client-side"
                    )
                samples = wave.shape[0]
                if samples < n:
                    raise ValueError(
                        f"need at least one MDCT block ({n} samples)"
                    )
                # gapless: CEIL to blocks (the batch buffer pads with
                # zeros) and record the exact length in the container
                blocks = -(-samples // n)
                parsed.append((req, wave, blocks, samples))
            except Exception as e:
                with self._lock:
                    self.stats["errors"] += 1
                req.finish(1, str(e).encode())
        if not parsed:
            return
        self._note_stage("parse", time.monotonic() - t_parse0)
        # one jitted call per (bucket_blocks, channels, wire) group,
        # batch padded to the next power of two
        groups: dict = {}
        for item in parsed:
            _, wave, blocks, _ = item
            bucket = max(self._min_blocks, _next_pow2(blocks))
            groups.setdefault(
                (bucket, wave.shape[-1], wave.dtype == np.int16), []
            ).append(item)
        # Dispatch each group's device work WITHOUT blocking on the
        # result, then hand readback+pack to the pool: the batch loop
        # goes straight back to coalescing the next batch while this
        # one reads back. _inflight bounds queued device work.
        for (bucket, ch, i16_wire), items in groups.items():
            g = _next_pow2(len(items))
            # acquire BEFORE dispatching so the semaphore bounds
            # dispatched device work (H2D upload included), not just
            # finalization
            t_acq0 = time.monotonic()
            self._inflight.acquire()
            t_disp0 = time.monotonic()
            self._note_stage("acquire", t_disp0 - t_acq0)
            try:
                if i16_wire:
                    handle = self._dispatch_i16(items, g, bucket, ch)
                else:
                    x = np.zeros((g, bucket * n, ch), dtype=np.float32)
                    for j, (_, wave, blocks, samples) in enumerate(items):
                        x[j, :samples] = wave
                    handle = self._enc(
                        self._codec, jnp.asarray(x, dtype=dtype)
                    )
                self._note_stage("dispatch", time.monotonic() - t_disp0)
            except Exception as e:
                self._inflight.release()
                with self._lock:
                    self.stats["errors"] += 1
                for req, *_ in items:
                    req.finish(1, str(e).encode())
                continue
            try:
                pool.submit(
                    self._finalize_batch, items, handle, g, bucket, ch,
                    i16_wire,
                )
            except RuntimeError as e:
                # executor shut down mid-stop: release the slot (it
                # would otherwise leak permanently) and fail the batch
                self._inflight.release()
                with self._lock:
                    self.stats["errors"] += 1
                for req, *_ in items:
                    req.finish(1, str(e).encode())

    def _dispatch_i16(self, items, g, bucket, ch):
        """Int16-wire group encode dispatch (async device handle).

        Ships ONE flat int16 buffer up; the device returns ONE flat
        int16 buffer (codes + bark bits + fits flag, see _enc_i16)."""
        import jax

        n = self._codec.mdct.filters_n
        x = np.zeros((g, bucket * n, ch), dtype=np.int16)
        for j, (_, wave, blocks, samples) in enumerate(items):
            x[j, :samples] = wave
        flat = jax.device_put(x.reshape(-1))
        out = self._enc_i16(self._codec, flat, g=g, s=bucket * n, ch=ch)
        return (out, x)

    def _finalize_batch(self, items, handle, g, bucket, ch, i16_wire):
        """Pool-side half: block on the device result, unpack, pack,
        respond. Runs concurrently with the batch loop's next dispatch."""
        try:
            t_read0 = time.monotonic()
            try:
                if i16_wire:
                    codes_h, bark_h = self._unpack_i16(
                        handle, g, bucket, ch
                    )
                else:
                    codes, bark = handle
                    codes_h, bark_h = np.asarray(codes), np.asarray(bark)
            except Exception as e:
                with self._lock:
                    self.stats["errors"] += 1
                for req, *_ in items:
                    req.finish(1, str(e).encode())
                return
            t_pack0 = time.monotonic()
            self._note_stage("readback", t_pack0 - t_read0)
            with self._lock:
                self.stats["encode_batches"] += 1
            for j, (req, _, blocks, samples) in enumerate(items):
                # frames 0..blocks fully determine the unpadded clip: a
                # frame depends only on blocks i-1, i and the pad blocks
                # are zeros — trimming is bit-identical to solo encode
                self._pack_one(
                    req,
                    codes_h[j : j + 1, : blocks + 1],
                    bark_h[j : j + 1, : blocks + 1],
                    samples,
                )
            self._note_stage("pack", time.monotonic() - t_pack0)
        finally:
            self._inflight.release()

    def _unpack_i16(self, handle, g, bucket, ch):
        """Flat int16 device result -> (codes int32, bark bf16) host
        arrays; falls back to the float/int32 path for the rare batch
        whose codes overflow int16."""
        import ml_dtypes

        out_dev, x = handle
        n = self._codec.mdct.filters_n
        out = np.asarray(out_dev)
        if out[-1]:
            blocks_out = bucket + 1
            nc = g * blocks_out * n * ch
            nb = g * blocks_out * self._bark_n * ch
            codes_h = out[:nc].astype(np.int32).reshape(
                g, blocks_out, n, ch
            )
            bark_h = out[nc : nc + nb].view(ml_dtypes.bfloat16).reshape(
                g, blocks_out, self._bark_n, ch
            )
            return codes_h, bark_h
        # overflow: at least one code needs >int16 — recompute via the
        # exact float path (int16/32768 is exact in float32)
        xf = x.astype(np.float32) * np.float32(1.0 / 32768.0)
        codes, bark = self._enc(
            self._codec,
            jnp.asarray(xf, dtype=self._codec.mdct.compute_dtype),
        )
        return np.asarray(codes), np.asarray(bark)

    def _pack_one(self, req, codes, bark, orig_samples=0):
        try:
            req.finish(0, bitstream.pack(codes, bark,
                                         orig_samples=orig_samples,
                                         **self._meta))
        except Exception as e:
            with self._lock:
                self.stats["errors"] += 1
            req.finish(1, str(e).encode())


class _StreamSession:
    """Connection-scoped streaming encode: the SAME StreamWriter and
    jitted streaming-MDCT step as offline encode_stream, writing into a
    BytesIO whose per-call deltas are the protocol responses — so the
    concatenated responses are byte-identical to the offline .acs."""

    def __init__(self, server, cfg_payload: bytes):
        import io as _io

        from audiocodec_tpu import quantize as _q
        from audiocodec_tpu import streaming as _streaming
        from audiocodec_tpu import tns as _tns_mod
        from audiocodec_tpu.io import stream_container as _sc

        cfg = json.loads(cfg_payload.decode() or "{}")
        if not isinstance(cfg, dict):
            raise ValueError("stream config must be a JSON object")
        codec = server._codec
        n = codec.mdct.filters_n
        self.channels = int(cfg.get("channels", 1))
        if not 1 <= self.channels <= 64:
            raise ValueError(f"channels out of range: {self.channels}")
        self.chunk_blocks = int(cfg.get("chunk_blocks", 64))
        if not 1 <= self.chunk_blocks <= 1 << 16:
            raise ValueError(
                f"chunk_blocks out of range: {self.chunk_blocks}"
            )
        self.ms = bool(cfg.get("ms", False))
        if self.ms and self.channels != 2:
            raise ValueError("ms coding needs exactly 2 channels")
        self.tscale = float(cfg.get("threshold_scale", 1.0))
        if not 0 < self.tscale < 2**32:
            raise ValueError(f"threshold_scale out of range: {self.tscale}")
        self.deadzone = float(cfg.get("deadzone", 0.5))
        if not 0.5 <= self.deadzone <= 2.0:
            raise ValueError(f"deadzone out of range: {self.deadzone}")
        self.tns = bool(cfg.get("tns", False))
        self.nf = bool(cfg.get("nf", False))
        self.tmask = float(cfg.get("tmask", 0.0))
        # 0 = off; positive values below 1 dB/s mean a >30 s masking
        # window — senseless physically and an easy resource sink
        if self.tmask != 0.0 and not 1.0 <= self.tmask < 1e6:
            raise ValueError(f"tmask out of range: {self.tmask}")
        self.bs = bool(cfg.get("bs", False))
        self.bwe = bool(cfg.get("bwe", False))
        self.intensity = bool(cfg.get("intensity", False))
        if self.intensity and not self.ms:
            raise ValueError("intensity stereo needs ms coding")
        self.cbr = bool(cfg.get("cbr", False))
        self.dtx = float(cfg.get("dtx", 0.0))
        if self.dtx and not -200.0 < self.dtx < 0.0:
            raise ValueError(f"dtx out of range: {self.dtx}")
        if self.dtx and self.cbr:
            raise ValueError("dtx does not compose with cbr sessions")
        # True so the FIRST chunk gates when below — offline
        # encode_stream's gate[0] = below[0] (no hangover precondition
        # before any active content has been seen)
        self._prev_below = True
        self._last_ts = self.tscale
        self._tctx = None
        self._codec = codec
        self._buf = _io.BytesIO()
        self._sent = 0
        self._writer = _sc.StreamWriter(
            self._buf,
            sample_rate=server._rate,
            filters_n=n,
            bark_bands_n=codec.psycho.bark_bands_n,
            alpha=codec.psycho.alpha,
            window_type=codec.mdct.window_type,
            channels=self.channels,
            compute_dtype=str(jnp.dtype(codec.mdct.compute_dtype)),
            ms=self.ms,
            # cbr streams record 1.0 stream-globally (per-chunk scales
            # ride the wire) — byte-identical to offline encode_stream
            threshold_scale=1.0 if self.cbr else self.tscale,
            bark_precision=codec.psycho.bark_precision,
            dz_recon=(
                _q.dz_recon_offset(self.deadzone)
                if self.deadzone != 0.5 else 0.0
            ),
            tns_order=_tns_mod.ORDER if self.tns else 0,
            tns_band_start=codec.tns_band_start if self.tns else 0,
            nf=self.nf,
            nf_band_start=codec.nf_band_start if self.nf else 0,
            nf_seed=int(cfg.get("nf_seed", 0)),
            bs=self.bs,
            bwe_start=codec.bwe_start if self.bwe else 0,
            is_start=codec.is_start if self.intensity else 0,
            sidecar_grid=codec.sidecar_grid,
            cbr=self.cbr,
            dtx_level=self.dtx,
        )
        self._carry = _streaming.mdct_stream_init(
            codec.mdct, 1, self.channels
        )
        self._step, self._flush = _sc._encode_chunk_fns()
        self._samples = self.chunk_blocks * n

    def take_bytes(self) -> bytes:
        data = self._buf.getvalue()
        out = data[self._sent:]
        self._sent = len(data)
        return out

    def feed(self, payload: bytes, tscale=None) -> bytes:
        """One chunk of PCM -> that chunk's .acs bytes. ``tscale``
        (adaptive sessions only, the protocol's "A" op) sets THIS
        chunk's rate-control scale — the network-adaptive streaming
        knob: the per-chunk scale rides the wire exactly like offline
        encode_stream_cbr's, so any .acs decoder plays the stream."""
        if tscale is not None:
            if not self.cbr:
                raise ValueError(
                    "per-chunk scales need a cbr session (begin_stream "
                    "cfg {'cbr': true})"
                )
            ts = float(tscale)
            if not 0 < ts < 2**32:
                raise ValueError(f"chunk scale out of range: {ts}")
        else:
            ts = self.tscale
        want = self._samples * self.channels * 4
        if len(payload) != want:
            raise ValueError(
                f"chunk payload must be {want} bytes of float32 PCM "
                f"({self._samples} samples x {self.channels} ch), got "
                f"{len(payload)}"
            )
        pcm = np.frombuffer(payload, "<f4").reshape(
            1, self._samples, self.channels
        )
        if self.dtx:
            # same gate as offline encode_stream: per-channel RMS vs
            # the dBFS threshold, one-chunk hangover after active
            # content. (Host f64 RMS here vs the offline path's device
            # f32 — decisions can only differ for chunks within float
            # roundoff of the gate, and the stream stays self-consistent
            # either way: the gate is encoder policy, decode honors the
            # wire.) Live sessions are DTX's canonical use (silence in
            # calls); a gated chunk costs ~(9+4C) bytes and no device
            # step.
            rms = np.sqrt((pcm.astype(np.float64) ** 2).mean(axis=1))[0]
            below = bool(rms.max() < 10.0 ** (self.dtx / 20.0))
            gated = below and self._prev_below
            self._prev_below = below
            if gated:
                from audiocodec_tpu import streaming as _streaming

                lv = (rms * (rms > 1e-12)).astype(np.float32)
                self._writer.append_silent(self.chunk_blocks, lv)
                # both ends treat the gated span as zeros (mirrors
                # offline encode_stream's carry/context reset)
                self._carry = _streaming.mdct_stream_init(
                    self._codec.mdct, 1, self.channels
                )
                self._tctx = None
                self._last_ts = ts
                return self.take_bytes()
        # device transfer only for chunks that actually encode — a gated
        # chunk costs no H2D bytes
        x = jnp.asarray(pcm, dtype=self._codec.mdct.compute_dtype)
        self._carry, self._tctx, enc, _ = self._step(
            self._codec, self._carry, x, 0.0, ts, self.ms,
            self.deadzone, self.tns, self.nf, tmask=self.tmask,
            tmask_context=self._tctx, bs=self.bs, bwe=self.bwe,
            intensity=self.intensity,
        )
        self._last_ts = ts
        self._writer.append(enc.codes, enc.bark16, enc.tns_idx,
                            enc.nf_levels,
                            tscale=ts if self.cbr else None,
                            bs_flags=enc.bs_flags,
                            bwe_gains=enc.bwe_gains,
                            is_gains=enc.is_gains)
        return self.take_bytes()

    def finish(self) -> bytes:
        # the flush frame reuses the last chunk's scale, mirroring
        # offline encode_stream's CBR behavior byte-for-byte
        out = self._flush(
            self._codec, self._carry, 0.0, self._last_ts, self.ms,
            self.deadzone, self.tns, self.nf, tmask=self.tmask,
            tmask_context=self._tctx, bs=self.bs, bwe=self.bwe,
            intensity=self.intensity,
        )
        self._writer.append(out.codes, out.bark16, out.tns_idx,
                            out.nf_levels,
                            tscale=self._last_ts if self.cbr else None,
                            bs_flags=out.bs_flags,
                            bwe_gains=out.bwe_gains,
                            is_gains=out.is_gains)
        self._writer.close()
        return self.take_bytes()


class _DecodeSession:
    """Connection-scoped streaming decode: the mirror of
    :class:`_StreamSession`. The client sends the .acs header once, then
    raw chunk bytes as they arrive off the wire; each response is that
    chunk's float32 PCM. Every chunk is re-framed as a one-chunk stream
    and parsed by the SAME StreamReader (CRC checks included), and the
    sample path is the same jitted step as offline decode_stream."""

    def __init__(self, server, header_bytes: bytes):
        import io as _io
        import struct as _struct

        from audiocodec_tpu import streaming as _streaming
        from audiocodec_tpu.io import stream_container as _sc

        if len(header_bytes) > 1 << 20:
            raise ValueError("stream header too large")
        # zero-chunk mini stream validates magic + meta via StreamReader
        empty = header_bytes + _struct.pack("<QQ", 0, len(header_bytes))
        r = _sc.StreamReader(_io.BytesIO(empty))
        meta = r.meta
        r.close()
        codec = server._codec
        server._check_container_config(meta)
        self._codec = codec
        self._header = header_bytes
        self._meta = meta
        self._ch = meta["channels"]
        self._ms = bool(meta.get("ms", False))
        self._tscale = float(meta.get("threshold_scale", 1.0))
        self._dzr = float(meta.get("dzr", 0.0))
        tns_meta = meta.get("tns")
        self._tns_bs = int(tns_meta["band_start"]) if tns_meta else 0
        nf_meta = meta.get("nf")
        self._nf_bs = int(nf_meta["band_start"]) if nf_meta else 0
        self._nf_seed = np.uint32(nf_meta["seed"]) if nf_meta else (
            np.uint32(0)
        )
        bwe_meta = meta.get("bwe")
        self._bwe_start = int(bwe_meta["start"]) if bwe_meta else 0
        is_meta = meta.get("isf")
        self._is_start = int(is_meta["start"]) if is_meta else 0
        self._frame_off = 0
        self._chunk_idx = 0
        self._carry = _streaming.imdct_stream_init(
            codec.mdct, 1, self._ch
        )
        self._step = _sc._decode_chunk_fns()[0]
        self._sc = _sc

    def feed(self, chunk_bytes: bytes) -> bytes:
        import io as _io
        import struct as _struct

        if len(chunk_bytes) > _MAX_PAYLOAD:
            raise ValueError("chunk too large")
        mini = (
            self._header + chunk_bytes
            + _struct.pack("<Q", len(self._header))
            + _struct.pack(
                "<QQ", 1, len(self._header) + len(chunk_bytes)
            )
        )
        r = self._sc.StreamReader(_io.BytesIO(mini))
        try:
            c = r.read_chunk(0)
        finally:
            r.close()

        def put_opt(t):
            return None if t is None else jax.device_put(t)

        self._carry, samples, _ = self._step(
            self._codec, self._carry, jax.device_put(c.codes),
            jax.device_put(c.bark),
            self._tscale if c.tscale is None else c.tscale,
            self._ms, self._dzr, put_opt(c.tns), self._tns_bs,
            put_opt(c.nfl), self._nf_bs, self._nf_seed, self._frame_off,
            bsw=put_opt(c.bsw), bwe=put_opt(c.bwe),
            bwe_start=self._bwe_start,
            isg=put_opt(c.isg), is_start=self._is_start,
        )
        if c.silent is not None and float(np.max(c.silent)) > 0:
            # DTX comfort noise, keyed by the session's chunk counter —
            # identical to offline decode_stream's per-index noise for a
            # stream fed in order from its start
            cn = np.random.default_rng(0xD7C0FFEE + self._chunk_idx)
            noise = (
                cn.standard_normal(
                    (1, samples.shape[1], self._ch)
                ).astype(np.float32)
                * c.silent[None, None, :]
            )
            samples = samples + jnp.asarray(
                noise, self._codec.mdct.compute_dtype
            )
        self._frame_off += c.codes.shape[0]
        self._chunk_idx += 1
        return np.ascontiguousarray(
            np.asarray(samples.astype(jnp.float32))[0], dtype="<f4"
        ).tobytes()

    def finish(self) -> bytes:
        from audiocodec_tpu import streaming as _streaming

        tail = _streaming.imdct_stream_flush(
            self._codec.mdct, self._carry
        )
        return np.ascontiguousarray(
            np.asarray(tail.astype(jnp.float32))[0], dtype="<f4"
        ).tobytes()


class Client:
    """Persistent-connection client for :class:`CodecServer`."""

    def __init__(self, host="127.0.0.1", port=None, unix_path=""):
        if unix_path:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.connect(unix_path)
        else:
            self._sock = socket.create_connection((host, port))

    def _call(self, op: str, payload: bytes) -> bytes:
        _write_frame(self._sock, ord(op), payload)
        status, resp = _read_frame(self._sock)
        if status != 0:
            raise RuntimeError(
                f"server error: {resp.decode(errors='replace')}"
            )
        return resp

    def encode(self, wav_bytes: bytes) -> bytes:
        """WAV blob -> .acz container bytes."""
        return self._call("E", wav_bytes)

    def decode(self, acz_bytes: bytes) -> bytes:
        """.acz container bytes -> WAV (16-bit PCM) blob."""
        return self._call("D", acz_bytes)

    def begin_stream(self, **cfg) -> bytes:
        """Open a streaming encode session; returns the .acs header
        bytes. Config keys: channels, chunk_blocks, threshold_scale,
        ms, deadzone, tns, nf, nf_seed, tmask, bs, cbr (per-chunk
        adaptive scales via feed(..., threshold_scale=)), dtx (dBFS
        gate — near-silent chunks cost ~10 bytes; VBR sessions only)."""
        return self._call("B", json.dumps(cfg).encode())

    def feed(self, pcm, threshold_scale=None) -> bytes:
        """One chunk of audio (float32 array [samples, channels] or raw
        little-endian float32 bytes) -> the .acs chunk bytes.
        ``threshold_scale`` sets THIS chunk's rate-control scale on an
        adaptive (cbr) session — raise it when the network chokes,
        lower it when headroom returns; the scale rides the stream so
        any decoder plays it."""
        if not isinstance(pcm, (bytes, bytearray)):
            pcm = np.ascontiguousarray(pcm, dtype="<f4").tobytes()
        if threshold_scale is None:
            return self._call("C", bytes(pcm))
        return self._call(
            "A", struct.pack("<d", float(threshold_scale)) + bytes(pcm)
        )

    def finish_stream(self) -> bytes:
        """Close the session; returns the flush chunk + index/trailer.
        header + chunks + this tail concatenated = a valid .acs file."""
        return self._call("F", b"")

    def begin_decode_stream(self, header_bytes: bytes) -> dict:
        """Open a streaming decode session from an .acs header; returns
        the stream's meta (sample_rate, channels, ...)."""
        meta = json.loads(self._call("J", header_bytes))
        self._dec_ch = int(meta["channels"])
        return meta

    def feed_chunk(self, chunk_bytes: bytes) -> np.ndarray:
        """One .acs chunk's raw bytes -> that chunk's float32 PCM
        [samples, channels]."""
        raw = self._call("K", chunk_bytes)
        return np.frombuffer(raw, "<f4").reshape(-1, self._dec_ch)

    def finish_decode_stream(self) -> np.ndarray:
        """Close the decode session; returns the final overlap-add tail."""
        raw = self._call("L", b"")
        return np.frombuffer(raw, "<f4").reshape(-1, self._dec_ch)

    def stats(self) -> dict:
        return json.loads(self._call("Q", b""))

    def close(self):
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def request(op: str, payload: bytes, host="127.0.0.1", port=None,
            unix_path="") -> bytes:
    """One-shot client call (connect, request, close)."""
    with Client(host, port, unix_path) as c:
        return c._call(op, payload)
