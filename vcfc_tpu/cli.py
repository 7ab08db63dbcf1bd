"""Command-line interface with the reference's argv shapes
(main.cpp:4028-4185):

  compress <input> <output>
  decompress <input> <output>
  query <input.vcfc> <region>
  gap-analysis <input.vcfc>
  sparsify <input.vcfc> <output>
  sparse-query <sparse-file> <region>
  create-binned-index <bin-size> <input.vcfc>      -> <input>.vcfci
  query-binned-index <input.vcfc> <region>
  create-sparse-index <input.vcfc>                 -> <input>.vcfci-sparse
  query-sparse-index <input.vcfc> <region>

Region syntax: "<ref>" or "<ref>:<start>-<end>".
"""

from __future__ import annotations

import os
import sys

from .format.constants import VCFC_BINNING_INDEX_EXTENSION
from .query.coordinate import parse_coordinate_string as _parse_region_raw
from .utils.config import SPARSE_EXTERNAL_INDEX_CONFIG, BinnedIndexConfig


def parse_coordinate_string(s: str):
    """Region parse with the reference's clean-error behavior: a bad
    region prints the message and exits 1 (main.cpp:4062-4068) instead of
    a traceback."""
    try:
        return _parse_region_raw(s)
    except ValueError as e:
        print(e)
        raise SystemExit(1)

USAGE = """usage: vcfc <action> ...
actions: compress decompress query gap-analysis sparsify sparse-query
         create-binned-index query-binned-index create-sparse-index
         query-sparse-index"""


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _emit(chunks) -> None:
    out = sys.stdout.buffer
    for chunk in chunks:
        out.write(chunk)
    out.flush()


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(USAGE, file=sys.stderr)
        return 1
    action, args = argv[0], argv[1:]

    if action in ("compress", "decompress"):
        if len(args) != 2:
            print(USAGE, file=sys.stderr)
            return 1
        input_filename, output_filename = args
        if not os.path.exists(input_filename):
            print(f"Input file does not exist: {input_filename}")
            return 1
        if input_filename == output_filename:
            raise RuntimeError("input and output file are the same")
        from . import engine

        sharded = os.environ.get("VCFC_SHARDED", "") not in ("", "0")
        stream_env = os.environ.get("VCFC_STREAM", "")
        threshold = int(os.environ.get("VCFC_STREAM_THRESHOLD", str(1 << 30)))
        use_stream = not sharded and (
            stream_env not in ("", "0")
            or (stream_env == "" and os.path.getsize(input_filename) > threshold)
        )
        if use_stream:
            # bounded-memory chunked engine (>RAM inputs; byte-identical
            # to the whole-buffer path — engine.compress_stream)
            if action == "compress":
                engine.compress_stream(input_filename, output_filename)
            else:
                engine.decompress_stream(input_filename, output_filename)
            return 0
        data = _read(input_filename)
        if sharded:
            # mesh-sharded codec steps over all visible devices
            # (pjit/shard_map; byte-identical to the single-device path)
            result = (
                engine.compress_sharded(data)
                if action == "compress"
                else engine.decompress_sharded(data)
            )
        else:
            result = (
                engine.compress(data) if action == "compress" else engine.decompress(data)
            )
        _write(output_filename, result)
        return 0

    if action == "query":
        if len(args) != 2:
            print(USAGE, file=sys.stderr)
            return 1
        from .query.engine import query_full_scan

        query = parse_coordinate_string(args[1])
        _emit(query_full_scan(_read(args[0]), query))
        return 0

    if action == "gap-analysis":
        if len(args) != 1:
            print(USAGE, file=sys.stderr)
            return 1
        from .query.engine import gap_analysis

        with open("start-positions.txt", "w") as f:
            for pos, size, compressed in gap_analysis(_read(args[0])):
                f.write(f"{pos.decode()} {size} {compressed}\n")
        return 0

    if action == "sparsify":
        if len(args) != 2:
            print(USAGE, file=sys.stderr)
            return 1
        input_filename, output_filename = args
        if input_filename == output_filename:
            raise RuntimeError("input and output file are the same")
        if not os.path.exists(input_filename):
            print(f"Input file does not exist: {input_filename}")
            return 1
        from .index.sparsify import sparsify_file

        sparsify_file(_read(input_filename), output_filename)
        return 0

    if action == "sparse-query":
        if len(args) != 2:
            print(USAGE, file=sys.stderr)
            return 1
        from .index.sparsify import query_sparse_file

        query = parse_coordinate_string(args[1])
        _emit(query_sparse_file(args[0], query))
        return 0

    if action == "create-binned-index":
        if len(args) != 2:
            print("Usage: vcfc create-binned-index <bin-size> <compressed-filename>")
            return 1
        try:
            bin_size = int(args[0])
            if bin_size <= 0:
                raise ValueError
        except ValueError:
            print("bin size must be a positive integer")
            return 1
        from .index.binned import build_binned_index

        input_filename = args[1]
        index = build_binned_index(_read(input_filename), BinnedIndexConfig(bin_size))
        _write(input_filename + VCFC_BINNING_INDEX_EXTENSION, index)
        return 0

    if action == "query-binned-index":
        if len(args) != 2:
            print("Usage: vcfc query-binned-index <compressed-filename> <region>")
            return 1
        input_filename = args[0]
        index_filename = input_filename + VCFC_BINNING_INDEX_EXTENSION
        for path in (input_filename, index_filename):
            if not os.path.exists(path):
                print(f"File does not exist: {path}")
                return 1
        from .index.binned import query_binned_index

        query = parse_coordinate_string(args[1])
        _emit(query_binned_index(_read(input_filename), _read(index_filename), query))
        return 0

    if action == "create-sparse-index":
        if len(args) != 1:
            print("Usage: vcfc create-sparse-index <compressed-filename>")
            return 1
        from .index.sparse_external import create_sparse_external_index

        input_filename = args[0]
        index_filename = input_filename + VCFC_BINNING_INDEX_EXTENSION + "-sparse"
        create_sparse_external_index(
            _read(input_filename), index_filename, SPARSE_EXTERNAL_INDEX_CONFIG
        )
        return 0

    if action == "query-sparse-index":
        if len(args) != 2:
            print("Usage: vcfc query-sparse-index <compressed-filename> <region>")
            return 1
        from .index.sparse_external import query_sparse_external_index

        input_filename = args[0]
        index_filename = input_filename + VCFC_BINNING_INDEX_EXTENSION + "-sparse"
        query = parse_coordinate_string(args[1])
        _emit(
            query_sparse_external_index(
                _read(input_filename), index_filename, query, SPARSE_EXTERNAL_INDEX_CONFIG
            )
        )
        return 0

    # --- block-manifest verbs (beyond reference parity) ---
    if action == "create-manifest":
        if len(args) != 1:
            print("Usage: vcfc create-manifest <compressed-filename>")
            return 1
        from .index.manifest import MANIFEST_EXTENSION, build_manifest

        _write(args[0] + MANIFEST_EXTENSION, build_manifest(_read(args[0])))
        return 0

    if action == "query-manifest":
        if len(args) != 2:
            print("Usage: vcfc query-manifest <compressed-filename> <region>")
            return 1
        from .index.manifest import MANIFEST_EXTENSION, Manifest, query_manifest

        manifest = Manifest(_read(args[0] + MANIFEST_EXTENSION))
        query = parse_coordinate_string(args[1])
        _emit(query_manifest(_read(args[0]), manifest, query))
        return 0

    # --- .vcfz extension verbs (beyond reference parity) ---
    if action == "compress-z":
        if len(args) not in (2, 3):
            print(
                "Usage: vcfc compress-z <input.vcf|.vcfc> <output.vcfz> [version]"
            )
            return 1
        from . import engine
        from .format.headers import decode_length_header
        from .format.vcf import parse_metadata_headers
        from .format.vcfz import VERSION, vcfz_from_vcfc

        try:
            z_version = int(args[2]) if len(args) == 3 else VERSION
        except ValueError:
            z_version = 0
        if z_version not in (1, 2, 3, 4, 5, 6, 7, 8):
            print("vcfz version must be 1-8")
            return 1
        data = _read(args[0])
        # accept plain VCF (compress first) or an existing .vcfc: a .vcfc
        # data line starts with a 0xC0-flagged length header, ASCII never does
        h = parse_metadata_headers(data)
        is_vcfc = False
        if h.data_offset < len(data):
            try:
                decode_length_header(data, h.data_offset)
                is_vcfc = True
            except Exception:  # short/odd tail: treat as VCF text
                is_vcfc = False
        vcfc = data if is_vcfc else engine.compress(data)
        _write(args[1], vcfz_from_vcfc(vcfc, version=z_version))
        return 0

    if action == "decompress-z":
        if len(args) != 2:
            print("Usage: vcfc decompress-z <input.vcfz> <output.vcf>")
            return 1
        from .format.vcfz import decompress_vcfz

        _write(args[1], decompress_vcfz(_read(args[0])))
        return 0

    if action == "query-z":
        if len(args) != 2:
            print("Usage: vcfc query-z <input.vcfz> <region>")
            return 1
        from .format.vcfz import query_vcfz

        query = parse_coordinate_string(args[1])
        _emit(query_vcfz(_read(args[0]), query))
        return 0

    print(f"Unknown action name: {action}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
