"""End-to-end device-path codec engine.

Wires the host layer (parse / assembly, native C++ or numpy) to the
device kernels (ops.rle) with static-shape batching: lines stream
through in fixed-size buckets so XLA compiles each kernel once per
(bucket, padded-width) shape.  Output is byte-for-byte identical to the
reference encoder — the oracle in ``vcfc_tpu.format`` defines the
contract; the engine is the fast path.
"""

from __future__ import annotations

import os

import numpy as np

from .host import native
from .host.assemble import assemble_vcf, assemble_vcfc, parse_vcfc_bytes
from .host.parse import parse_vcf_bytes
from .ops.rle import rle_decode, rle_encode, text_rle_decode, text_rle_encode

_LINE_BATCH = 2048
# Below this many genotype cells the XLA compile + dispatch overhead
# dominates; route through the host oracle instead.
_DEVICE_MIN_CELLS = 1 << 18
# Cap genotype cells per device batch: wide cohorts (S >> 4096) shrink the
# line batch instead of growing the buffer, bounding device memory at
# ~64 MB per u8 buffer regardless of sample width (VERDICT r1 #5).  The
# positional-scan kernels themselves support widths to 2^23 (ops/rle.py).
_TARGET_BATCH_CELLS = 1 << 26


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _force_device(flag: bool) -> bool:
    """CLI/test knob: VCFC_FORCE_DEVICE=1 disables the min-cells gate so
    device routes are exercised even on tiny inputs (the verification
    gauntlet must not silently fall back to the oracle)."""
    return flag or os.environ.get("VCFC_FORCE_DEVICE", "") not in ("", "0")


def _adaptive_line_batch(line_batch: int, s_pad: int) -> int:
    """Shrink the line batch for wide sample axes so a batch never exceeds
    ~_TARGET_BATCH_CELLS genotype cells (floor 256 lines; shrunk batches
    stay multiples of 256 so nearby widths share compiled shapes)."""
    cap = _TARGET_BATCH_CELLS // s_pad // 256 * 256
    return max(256, min(line_batch, cap))


def _compress_device_text(
    vcf: bytes, line_batch: int, force_device: bool = False
) -> bytes | None:
    """VCFC_PARSE=device route: ASCII classification moves onto the device
    (fused classify+encode, ops/rle.py::text_rle_encode) — the
    host's per-byte classify pass disappears; what remains host-side is
    line indexing, a strided text gather (memcpy-class), and escape
    splicing during assembly.  Replaces the reference's per-sample scan
    (compress.cpp:124-186).  Returns None to fall back (tiny input)."""
    from .format.lines import VcfValidationError
    from .format.vcf import parse_metadata_headers
    from .host.fast import assemble_vcfc_native
    from .host.parse import ParsedVcf

    header = parse_metadata_headers(vcf)
    S = header.schema.sample_count
    raw_np = np.frombuffer(vcf, np.uint8)
    line_start, line_end, sample_start = native.index_lines(
        raw_np, header.data_offset
    )
    keep = line_end > line_start  # drop empty lines (compress.cpp:219-221)
    line_start, line_end = line_start[keep], line_end[keep]
    sample_start = sample_start[keep]
    body = raw_np[header.data_offset :]
    L = len(line_start)
    if L == 0 or S == 0 or (L * S < _DEVICE_MIN_CELLS and not force_device):
        return None
    if (sample_start < 0).any():
        bad = int(np.flatnonzero(sample_start < 0)[0])
        raise VcfValidationError(
            f"data line {bad} has no FORMAT column (fewer than 9 tabs)"
        )
    irregular = (line_end - sample_start) != (4 * S - 1)
    S_pad = max(_round_up(S, 128), 128)
    line_batch = _adaptive_line_batch(line_batch, S_pad)
    flagpos = np.zeros((L, S_pad), np.uint8)
    nseg = np.zeros(L, np.int32)
    seps = np.ones(L, np.int32)
    futures = []
    for lo in range(0, L, line_batch):
        hi = min(lo + line_batch, L)
        # padded per-batch views; pad rows marked irregular stay zero
        ss = np.zeros(line_batch, np.int64)
        ss[: hi - lo] = sample_start[lo:hi]
        ir = np.ones(line_batch, np.uint8)
        ir[: hi - lo] = irregular[lo:hi]
        text = native.gather_text(body, ss, ir, S, S_pad)
        futures.append((lo, hi, text_rle_encode(text.view(np.int32), S)))
    for lo, hi, (f, k, r) in futures:
        flagpos[lo:hi] = np.asarray(f)[: hi - lo]
        nseg[lo:hi] = np.asarray(k)[: hi - lo]
        seps[lo:hi] = np.asarray(r)[: hi - lo]
    # rows whose separator bytes weren't tabs were mis-sliced: oracle path
    irregular |= seps == 0
    # codes are never read by the native assembly (it splices escape ASCII
    # straight from the text); a (0, S) array just carries the width
    parsed = ParsedVcf(
        header, body, line_start, line_end, sample_start,
        np.zeros((0, S), np.uint8), irregular,
    )
    return assemble_vcfc_native(parsed, flagpos, nseg)


def compress(vcf: bytes, line_batch: int = _LINE_BATCH, force_device: bool = False) -> bytes:
    """Device-path compress: parse -> RLE encode on device -> assemble."""
    force_device = _force_device(force_device)
    line_batch = max(line_batch, 1)
    if native.available() and os.environ.get("VCFC_PARSE") == "device":
        out = _compress_device_text(vcf, line_batch, force_device)
        if out is not None:
            return out
    parsed = parse_vcf_bytes(vcf)
    L, S = parsed.n_lines, parsed.n_samples
    if L == 0 or S == 0 or (L * S < _DEVICE_MIN_CELLS and not force_device):
        from .format.vcf import compress_bytes

        return compress_bytes(vcf)

    if native.available() and os.environ.get("VCFC_EXECUTOR", "device") == "host":
        flagpos, nseg = native.rle_encode_host(parsed.codes, S)
    else:
        S_pad = max(_round_up(S, 128), 128)
        line_batch = _adaptive_line_batch(line_batch, S_pad)
        flagpos = np.zeros((L, S_pad), np.uint8)
        nseg = np.zeros(L, np.int32)

        # dispatch all batches first (async), then fetch
        futures = []
        for lo in range(0, L, line_batch):
            hi = min(lo + line_batch, L)
            batch = np.zeros((line_batch, S_pad), np.uint8)
            batch[: hi - lo, :S] = parsed.codes[lo:hi]
            futures.append((lo, hi, rle_encode(batch, S)))
        for lo, hi, (f, k) in futures:
            flagpos[lo:hi] = np.asarray(f)[: hi - lo]
            nseg[lo:hi] = np.asarray(k)[: hi - lo]

    if native.available():
        from .host.fast import assemble_vcfc_native

        return assemble_vcfc_native(parsed, flagpos, nseg)
    return assemble_vcfc(parsed, flagpos, nseg)


# ---------------------------------------------------------------------------
# Streaming file codec (VERDICT r3 #3).  compress()/decompress() buffer the
# whole file; these twins run the same engine over bounded line-aligned
# chunks so >RAM inputs work without the native CLI (whose streaming
# bounded-buffer paths are vcfcq.cpp:681,805).  Every data line is
# self-contained (compress.cpp:5), so chunk outputs concatenate exactly:
# the streamed bytes are identical to the whole-buffer engine's.

_STREAM_CHUNK = 64 << 20  # default chunk; VCFC_STREAM_CHUNK overrides


def _stream_chunk(chunk_bytes: int | None) -> int:
    if chunk_bytes:
        return max(int(chunk_bytes), 1 << 12)
    return max(int(os.environ.get("VCFC_STREAM_CHUNK", _STREAM_CHUNK)), 1 << 12)


def _open_pair(src, dst):
    """(src, dst) as binary file objects; paths are opened (and closed by
    the caller via the returned closers)."""
    closers = []
    if isinstance(src, (str, bytes, os.PathLike)):
        src = open(src, "rb")
        closers.append(src)
    if isinstance(dst, (str, bytes, os.PathLike)):
        dst = open(dst, "wb")
        closers.append(dst)
    return src, dst, closers


def _read_header_lines(f):
    """Consume '#'-prefixed header lines from a stream; returns (header,
    header_blob, carry) where carry holds the bytes readline() consumed
    past the header (the start of the first data line — or, for .vcfc
    input, an arbitrary binary prefix of it: it is never interpreted,
    only prepended to the first chunk)."""
    from .format.vcf import parse_metadata_headers

    lines = []
    carry = b""
    while True:
        line = f.readline()
        if not line:
            break
        if line[:1] == b"#":
            lines.append(line)
        else:
            carry = line
            break
    header_blob = b"".join(lines)
    header = parse_metadata_headers(header_blob)  # validates + sample count
    return header, header_blob, carry


def compress_stream(src, dst, chunk_bytes: int | None = None) -> int:
    """Chunked compress: VCF path/stream -> .vcfc path/stream with peak
    memory bounded by the chunk size (plus the engine's own per-chunk
    working set), byte-identical to ``compress`` of the whole file.
    Returns the number of compressed bytes written."""
    chunk = _stream_chunk(chunk_bytes)
    fin, fout, closers = _open_pair(src, dst)
    try:
        _header, header_blob, carry = _read_header_lines(fin)
        fout.write(header_blob)
        written = len(header_blob)
        hb = len(header_blob)
        eof = False
        while not eof or carry:
            data = fin.read(chunk)
            if not data:
                eof = True
            buf = carry + data
            if not buf:
                break
            if eof:
                piece, carry = buf, b""
            else:
                cut = buf.rfind(b"\n")
                if cut < 0:  # a single line longer than the chunk: grow
                    carry = buf
                    continue
                piece, carry = buf[: cut + 1], buf[cut + 1 :]
            if not piece:
                continue
            out = compress(header_blob + piece)
            fout.write(out[hb:])
            written += len(out) - hb
        return written
    finally:
        for f in closers:
            f.close()


def decompress_stream(src, dst, chunk_bytes: int | None = None) -> int:
    """Chunked decompress: .vcfc path/stream -> VCF path/stream, the
    decode twin of ``compress_stream`` (chunks split at compressed-line
    boundaries by hopping the 4-byte length headers).  Byte-identical to
    ``decompress`` of the whole file; returns bytes written."""
    from .format.headers import decode_line_headers
    from .format.lines import VcfValidationError

    chunk = _stream_chunk(chunk_bytes)
    fin, fout, closers = _open_pair(src, dst)
    try:
        _header, header_blob, carry = _read_header_lines(fin)
        fout.write(header_blob)
        written = len(header_blob)
        hb = len(header_blob)
        eof = False
        while not eof or carry:
            data = fin.read(chunk)
            if not data:
                eof = True
            buf = carry + data
            if not buf:
                break
            # complete compressed lines only (a line is 4 + line_length
            # bytes and always holds both 4-byte headers, so 8 readable
            # bytes at a line start suffice to size it)
            pos, n = 0, len(buf)
            while pos + 8 <= n:
                line_length, _req = decode_line_headers(buf, pos)
                if pos + 4 + line_length > n:
                    break
                pos += 4 + line_length
            if pos == 0:
                if eof:
                    raise VcfValidationError(
                        "truncated .vcfc stream: partial line at EOF"
                    )
                carry = buf  # line longer than the chunk: grow
                continue
            piece, carry = buf[:pos], buf[pos:]
            text = decompress(header_blob + piece)
            fout.write(text[hb:])
            written += len(text) - hb
        if carry:
            raise VcfValidationError("truncated .vcfc stream: partial line at EOF")
        return written
    finally:
        for f in closers:
            f.close()


_SHARDED_STEPS: dict = {}


def _sharded_step_for(mesh):
    """Memoize the jitted sharded step per mesh: a fresh shard_map
    closure per call would miss the jit cache and retrace every
    invocation."""
    key = (tuple(d.id for d in mesh.devices.flat), mesh.axis_names)
    step = _SHARDED_STEPS.get(key)
    if step is None:
        from .parallel.shard import make_sharded_encode_step

        step = _SHARDED_STEPS[key] = make_sharded_encode_step(mesh)
    return step


def compress_sharded(vcf: bytes, mesh=None) -> bytes:
    """Compress with the encode step sharded over a device mesh (data
    parallelism across the line axis; pjit/shard_map with psum-merged
    histogram + deterministic shard offsets).  Byte-identical to
    ``compress`` — this is the multi-chip compute path end to end, also
    exercised on the virtual CPU mesh in tests."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .parallel.mesh import DATA_AXIS, make_data_mesh

    parsed = parse_vcf_bytes(vcf)
    L, S = parsed.n_lines, parsed.n_samples
    if L == 0 or S == 0:
        from .format.vcf import compress_bytes

        return compress_bytes(vcf)

    if mesh is None:
        mesh = make_data_mesh(len(jax.devices()))
    n_dev = mesh.devices.size
    S_pad = max(_round_up(S, 128), 128)
    # chunked like the single-device path: one fixed-shape compile, and
    # device memory bounded by the batch cap instead of the whole file;
    # the chunk splits evenly over the mesh's data axis
    chunk = _round_up(_adaptive_line_batch(_LINE_BATCH, S_pad), n_dev)
    step = _sharded_step_for(mesh)
    flagpos = np.zeros((L, S_pad), np.uint8)
    nseg = np.zeros(L, np.int32)
    for lo in range(0, L, chunk):
        hi = min(lo + chunk, L)
        codes = np.zeros((chunk, S_pad), np.uint8)
        codes[: hi - lo, :S] = parsed.codes[lo:hi]
        sharded = jax.device_put(
            jnp.asarray(codes), NamedSharding(mesh, P(DATA_AXIS, None))
        )
        f, k, _hist, _offsets = step(sharded, jnp.int32(S))
        flagpos[lo:hi] = np.asarray(f)[: hi - lo]
        nseg[lo:hi] = np.asarray(k)[: hi - lo]

    if native.available():
        from .host.fast import assemble_vcfc_native

        return assemble_vcfc_native(parsed, flagpos, nseg)
    return assemble_vcfc(parsed, flagpos, nseg)


def _sharded_decode_step_for(mesh):
    key = (tuple(d.id for d in mesh.devices.flat), mesh.axis_names, "decode")
    step = _SHARDED_STEPS.get(key)
    if step is None:
        from .parallel.shard import make_sharded_decode_step

        step = _SHARDED_STEPS[key] = make_sharded_decode_step(mesh)
    return step


def decompress_sharded(vcfc: bytes, mesh=None) -> bytes:
    """Decompress with the decode step sharded over a device mesh — the
    file-level decode twin of ``compress_sharded`` (VERDICT r1 #2): lines
    shard across the data axis, each device run-fills its shard, and the
    host renders the gathered codes.  Byte-identical to ``decompress``
    (the reference's sequential spec: decompress2_fd, compress.cpp:1214)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .parallel.mesh import DATA_AXIS, make_data_mesh

    use_native = native.available()
    if use_native:
        from .host.fast import parse_vcfc_native

        parsed = parse_vcfc_native(vcfc)
    else:
        parsed = parse_vcfc_bytes(vcfc)
    L = parsed.n_lines
    S = parsed.header.schema.sample_count
    if L == 0 or S == 0:
        from .format.vcf import decompress_bytes

        return decompress_bytes(vcfc)

    if mesh is None:
        mesh = make_data_mesh(len(jax.devices()))
    n_dev = mesh.devices.size
    W = parsed.flags.shape[1]
    S_pad = max(_round_up(max(S, W), 128), 128)
    # chunked like compress_sharded: bounded device memory, one compile
    chunk = _round_up(_adaptive_line_batch(_LINE_BATCH, S_pad), n_dev)
    step = _sharded_decode_step_for(mesh)
    codes = np.zeros((L, S_pad), np.uint8)
    decoded = np.zeros(L, np.int32)
    for lo in range(0, L, chunk):
        hi = min(lo + chunk, L)
        flags = np.zeros((chunk, S_pad), np.uint8)
        flags[: hi - lo, :W] = parsed.flags[lo:hi]
        sharded = jax.device_put(
            jnp.asarray(flags), NamedSharding(mesh, P(DATA_AXIS, None))
        )
        c, d = step(sharded, jnp.int32(S))
        codes[lo:hi] = np.asarray(c)[: hi - lo]
        decoded[lo:hi] = np.asarray(d)[: hi - lo]

    if use_native:
        from .host.fast import assemble_vcf_native

        return assemble_vcf_native(parsed, codes, decoded)
    from .ops.rle import render_text

    return assemble_vcf(parsed, render_text(codes), decoded)


def _decompress_device_unpack(
    vcfc: bytes, line_batch: int, force_device: bool = False
):
    """VCFC_UNPACK=device route: the host extracts PACKED flag bytes
    (O(compressed size)) and the device does the packed->positional matmul
    unpack fused with the run-fill (ops/rle.py::unpack_rle_decode) —
    no O(L*W) positional plane on the host, H2D traffic ~8x smaller on
    typical cohorts.  Returns (bytes, None) on success; (None, scan)
    to fall back (tiny input — the scan tuple lets the fallback parse
    skip the header parse + stream scan it already paid)."""
    from .format.vcf import parse_metadata_headers
    from .host.fast import assemble_vcf_native, parse_vcfc_packed_native
    from .ops.rle import unpack_rle_decode

    # cheap pre-gate (header + native scan) BEFORE the packed extraction:
    # a declining call must not pay the full parse twice
    header = parse_metadata_headers(vcfc)
    S = header.schema.sample_count
    raw_np = np.frombuffer(vcfc, np.uint8)
    max_lines = max((len(vcfc) - header.data_offset) // 10 + 2, 16)
    line_off, line_len, req_len = native.scan_vcfc(
        raw_np, header.data_offset, max_lines
    )
    scan = (header, line_off, line_len, req_len)
    L = len(line_off)
    if L == 0 or S == 0 or (L * S < _DEVICE_MIN_CELLS and not force_device):
        return None, scan
    parsed = parse_vcfc_packed_native(vcfc, scan=scan)
    import jax.numpy as jnp

    M = parsed.flags.shape[1]
    S_pad = max(_round_up(S, 128), 128)
    # the matmul unpack's indicator operands cost ~M*(S_pad/128 + 128)*2
    # bytes of bf16 PER LINE — unlike the dense kernels, memory scales
    # with the flag density M, so cap the batch by that too; het- or
    # escape-dense inputs where even a 256-line batch exceeds the budget
    # fall back to the host-unpack route
    per_line = M * (S_pad // 128 + 128) * 2
    cap = (256 << 20) // max(per_line, 1) // 256 * 256
    if cap < 256:
        return None, scan
    line_batch = min(_adaptive_line_batch(line_batch, S_pad), cap)
    codes = np.zeros((L, S_pad), np.uint8)
    decoded = np.zeros(L, np.int32)
    futures = []
    for lo in range(0, L, line_batch):
        hi = min(lo + line_batch, L)
        batch = np.zeros((line_batch, M), np.uint8)
        batch[: hi - lo] = parsed.flags[lo:hi]
        counts = np.zeros(line_batch, np.int32)
        counts[: hi - lo] = parsed.nflags[lo:hi]
        futures.append(
            (lo, hi, unpack_rle_decode(batch, counts, jnp.int32(S), out_width=S_pad))
        )
    for lo, hi, (c, d) in futures:
        codes[lo:hi] = np.asarray(c)[: hi - lo]
        decoded[lo:hi] = np.asarray(d)[: hi - lo]
    return assemble_vcf_native(parsed, codes, decoded), None


def _decompress_device_text(parsed, line_batch: int, force_device: bool) -> bytes | None:
    """VCFC_PARSE=device decode route: the fused decode+render kernel
    (ops/rle.py::text_rle_decode) emits "a|b\\t" ASCII words on
    the device; host assembly memcpys the text plane and splices escapes
    (host/fast.py::assemble_vcf_from_text).  The host LUT-render pass
    disappears; D2H ships 4 text bytes/sample instead of 1 code byte —
    choose by transfer vs host-compute balance.  Returns None to fall
    back (tiny input)."""
    import jax.numpy as jnp  # noqa: F401  (device backend init)

    from .host.fast import assemble_vcf_from_text

    L = parsed.n_lines
    S = parsed.header.schema.sample_count
    if L == 0 or S == 0 or (L * S < _DEVICE_MIN_CELLS and not force_device):
        return None
    W = parsed.flags.shape[1]
    S_pad = max(_round_up(max(S, W), 128), 128)
    line_batch = _adaptive_line_batch(line_batch, S_pad)
    text = np.zeros((L, 4 * S_pad), np.uint8)
    decoded = np.zeros(L, np.int32)
    futures = []
    for lo in range(0, L, line_batch):
        hi = min(lo + line_batch, L)
        batch = np.zeros((line_batch, S_pad), np.uint8)
        batch[: hi - lo, :W] = parsed.flags[lo:hi]
        futures.append((lo, hi, text_rle_decode(batch, S)))
    for lo, hi, (t, _c, d) in futures:
        # i32 words -> little-endian byte plane, zero-copy view
        text[lo:hi] = np.asarray(t).view(np.uint8)[: hi - lo]
        decoded[lo:hi] = np.asarray(d)[: hi - lo]
    return assemble_vcf_from_text(parsed, text, decoded)


def decompress(vcfc: bytes, line_batch: int = _LINE_BATCH, force_device: bool = False) -> bytes:
    """Device-path decompress: unpack stream -> RLE decode on device -> render."""
    force_device = _force_device(force_device)
    line_batch = max(line_batch, 1)
    use_native = native.available()
    scan = None
    if use_native and os.environ.get("VCFC_UNPACK") == "device":
        out, scan = _decompress_device_unpack(vcfc, line_batch, force_device)
        if out is not None:
            return out
    if use_native:
        from .host.fast import parse_vcfc_native

        parsed = parse_vcfc_native(vcfc, scan=scan)
        if os.environ.get("VCFC_PARSE") == "device":
            out = _decompress_device_text(parsed, line_batch, force_device)
            if out is not None:
                return out
    else:
        parsed = parse_vcfc_bytes(vcfc)
    L = parsed.n_lines
    S = parsed.header.schema.sample_count
    if L == 0 or S == 0 or (L * S < _DEVICE_MIN_CELLS and not force_device):
        from .format.vcf import decompress_bytes

        return decompress_bytes(vcfc)

    W = parsed.flags.shape[1]
    if use_native and os.environ.get("VCFC_EXECUTOR", "device") == "host":
        # host executor: thread-parallel run-fill in C++ — useful when
        # device transfers dominate
        codes = native.expand_codes(parsed.flags, S)
        decoded = np.full(L, S, np.int32)  # unpack already validated shape
    else:
        S_pad = max(_round_up(max(S, W), 128), 128)
        line_batch = _adaptive_line_batch(line_batch, S_pad)
        codes = np.zeros((L, S_pad), np.uint8)
        decoded = np.zeros(L, np.int32)

        # dispatch all batches first (async), then fetch: overlaps H2D,
        # compute, and D2H across batches
        futures = []
        for lo in range(0, L, line_batch):
            hi = min(lo + line_batch, L)
            batch = np.zeros((line_batch, S_pad), np.uint8)
            batch[: hi - lo, :W] = parsed.flags[lo:hi]
            futures.append((lo, hi, rle_decode(batch, S)))
        for lo, hi, (c, d) in futures:
            codes[lo:hi] = np.asarray(c)[: hi - lo]
            decoded[lo:hi] = np.asarray(d)[: hi - lo]

    if use_native:
        from .host.fast import assemble_vcf_native

        return assemble_vcf_native(parsed, codes, decoded)
    from .ops.rle import render_text

    return assemble_vcf(parsed, render_text(codes), decoded)
