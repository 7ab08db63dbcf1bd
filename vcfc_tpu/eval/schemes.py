"""Query schemes under measurement.

Five schemes mirror the reference harness (evaluation_main.py,
command.py): three VCFC index strategies plus tabix over bgzip and BCF.
Ours run in-process or via the native CLI; the external tabix/bcftools
schemes shell out to PATH htslib when installed and otherwise to the
in-tree from-spec minihts implementation (native/htsbin).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from dataclasses import dataclass

from ..index.binned import build_binned_index, query_binned_index
from ..index.sparse_external import (
    create_sparse_external_index,
    query_sparse_external_index,
)
from ..index.sparsify import query_sparse_file, sparsify_file
from ..query.coordinate import CoordinateQuery
from ..utils.config import SPARSE_EXTERNAL_INDEX_CONFIG, BinnedIndexConfig, SparseConfig
from .config import Dataset


import functools


@functools.lru_cache(maxsize=1)
def _try_build_htsbin() -> None:
    """One-shot build attempt (cached): a machine where the build cannot
    succeed must fail once, not re-run a 180 s make per tool lookup."""
    import subprocess as sp

    native_dir = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "native")
    )
    try:
        sp.run(
            ["make", "-C", native_dir, "htsbin"],
            capture_output=True,
            timeout=180,
            check=False,
        )
    except Exception:
        pass


def _tool(name: str) -> tuple[str, str] | None:
    """External tool lookup: PATH first (real htslib wins when present),
    then the in-tree minihts fallback (native/htsbin — a from-spec BGZF/
    tabix/BCF implementation, built on demand) so the reference's
    headline tabix/BCF comparison runs even on hermetic machines.

    Returns (path, backend) where backend is "htslib" (a real PATH
    install) or "minihts-standin" — recorded in the scheme and the eval
    JSON so stand-in timings are never mistaken for real-htslib ones."""
    found = shutil.which(name)
    if found:
        return found, "htslib"
    htsbin = os.path.join(
        os.path.dirname(__file__), "..", "..", "native", "htsbin"
    )
    path = os.path.abspath(os.path.join(htsbin, name))
    if not os.path.exists(path):
        _try_build_htsbin()
    return (path, "minihts-standin") if os.path.exists(path) else None


@dataclass
class PreparedScheme:
    name: str
    query_single_fn: object  # (ref, pos) -> bytes
    query_range_fn: object  # (ref, start, end) -> bytes
    index_path: str | None = None
    # which binary actually answered: "vcfc" for in-tree schemes,
    # "htslib" / "minihts-standin" for the external tabix/bcftools rows
    backend: str = "vcfc"


class SchemeFactory:
    """Prepares compressed artifacts once per dataset and builds
    per-scheme query callables."""

    def __init__(self, dataset: Dataset, workdir: str, bin_size: int = 150):
        self.dataset = dataset
        self.workdir = workdir
        self.bin_size = bin_size
        os.makedirs(workdir, exist_ok=True)
        self.vcfc_path = os.path.join(workdir, dataset.name + ".vcfc")
        if not os.path.exists(self.vcfc_path):
            from .. import engine

            with open(dataset.vcf_path, "rb") as f:
                vcf = f.read()
            # atomic publish: a run killed mid-write must not leave a
            # truncated .vcfc that later runs trust as cached
            tmp = self.vcfc_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(engine.compress(vcf))
            os.replace(tmp, self.vcfc_path)
        with open(self.vcfc_path, "rb") as f:
            self.vcfc = f.read()

    # -- VCFC schemes -----------------------------------------------------

    def vcfc_binned(self, bin_size: int | None = None) -> PreparedScheme:
        bin_size = bin_size or self.bin_size
        index = build_binned_index(self.vcfc, BinnedIndexConfig(bin_size))
        index_path = self.vcfc_path + f".vcfci-{bin_size}"
        with open(index_path, "wb") as f:
            f.write(index)

        def single(ref, pos):
            return b"".join(
                query_binned_index(self.vcfc, index, CoordinateQuery.range(ref, pos, pos))
            )

        def range_(ref, start, end):
            return b"".join(
                query_binned_index(self.vcfc, index, CoordinateQuery.range(ref, start, end))
            )

        return PreparedScheme(f"vcfc-binned-{bin_size}", single, range_, index_path)

    def vcfc_sparse(self, force_rebuild: bool = False) -> PreparedScheme:
        sparse_path = self.vcfc_path + ".sparse"
        config = SparseConfig()
        if force_rebuild and os.path.exists(sparse_path):
            os.unlink(sparse_path)
        if not os.path.exists(sparse_path):
            sparsify_file(self.vcfc, sparse_path, config)

        def single(ref, pos):
            return b"".join(
                query_sparse_file(sparse_path, CoordinateQuery.range(ref, pos, pos), config)
            )

        def range_(ref, start, end):
            return b"".join(
                query_sparse_file(
                    sparse_path, CoordinateQuery.range(ref, start, end), config
                )
            )

        return PreparedScheme("vcfc-sparse", single, range_, sparse_path)

    def vcfc_sparse_external(self, force_rebuild: bool = False) -> PreparedScheme:
        index_path = self.vcfc_path + ".vcfci-sparse"
        config = SPARSE_EXTERNAL_INDEX_CONFIG
        if force_rebuild and os.path.exists(index_path):
            os.unlink(index_path)
        if not os.path.exists(index_path):
            create_sparse_external_index(self.vcfc, index_path, config)

        def single(ref, pos):
            return b"".join(
                query_sparse_external_index(
                    self.vcfc, index_path, CoordinateQuery.range(ref, pos, pos), config
                )
            )

        def range_(ref, start, end):
            return b"".join(
                query_sparse_external_index(
                    self.vcfc, index_path, CoordinateQuery.range(ref, start, end), config
                )
            )

        return PreparedScheme("vcfc-sparse-external", single, range_, index_path)

    def vcfc_binned_native(self, bin_size: int | None = None) -> PreparedScheme | None:
        """Binned-index queries through the native CLI (native/vcfcq), one
        process per query — apples-to-apples with the reference binary and
        the tabix schemes, without interpreter startup in the loop."""
        from ..host.native import cli_path

        cli = cli_path()
        if cli is None:
            return None
        bin_size = bin_size or self.bin_size
        # vcfcq reads <vcfc>.vcfci; build it with the native binary so
        # index-creation timings measure the native path end to end
        # (byte-identical to the Python builder, tests/test_native_cli.py)
        index_path = self.vcfc_path + ".vcfci"
        subprocess.run(
            [cli, "create-binned-index", str(bin_size), self.vcfc_path], check=True
        )

        def single(ref, pos):
            return subprocess.run(
                [cli, "query-binned-index", self.vcfc_path, f"{ref}:{pos}-{pos}"],
                capture_output=True,
                check=True,
            ).stdout

        def range_(ref, start, end):
            return subprocess.run(
                [cli, "query-binned-index", self.vcfc_path, f"{ref}:{start}-{end}"],
                capture_output=True,
                check=True,
            ).stdout

        return PreparedScheme(f"vcfc-binned-native-{bin_size}", single, range_, index_path)

    def vcfc_manifest_native(self, force_rebuild: bool = False) -> PreparedScheme | None:
        """Point/range queries over the `.vcfcm` columnar manifest through
        the native CLI, one process per query — the framework's own index
        design (explicit offset tables, one decode per matching line;
        index/manifest.py) under the same per-process protocol as the
        binned and tabix schemes.  Reads scale with the HIT count, not
        the bin size — the cold-cache regime is where that shows."""
        from ..host.native import cli_path

        cli = cli_path()
        if cli is None:
            return None
        mpath = self.vcfc_path + ".vcfcm"
        if force_rebuild and os.path.exists(mpath):
            os.unlink(mpath)
        if not os.path.exists(mpath):
            subprocess.run([cli, "create-manifest", self.vcfc_path], check=True)

        def single(ref, pos):
            return subprocess.run(
                [cli, "query-manifest", self.vcfc_path, f"{ref}:{pos}-{pos}"],
                capture_output=True,
                check=True,
            ).stdout

        def range_(ref, start, end):
            return subprocess.run(
                [cli, "query-manifest", self.vcfc_path, f"{ref}:{start}-{end}"],
                capture_output=True,
                check=True,
            ).stdout

        return PreparedScheme("vcfc-manifest-native", single, range_, mpath)

    def vcfz(self, version: int = 3, force_rebuild: bool = False) -> PreparedScheme | None:
        """Range queries over the entropy-coded `.vcfz` container through
        the native CLI (`vcfcq query-z`), one process per query — measures
        the extension format's random access against the index schemes.
        version 4 adds vertical prediction (see format/vcfz.py)."""
        from ..host.native import cli_path

        cli = cli_path()
        if cli is None:
            return None
        z_path = os.path.join(self.workdir, f"{self.dataset.name}.v{version}.vcfz")
        if force_rebuild and os.path.exists(z_path):
            # "index creation" for .vcfz is the whole transcode: the
            # container is its own random-access index (block table)
            os.unlink(z_path)
        if not os.path.exists(z_path):
            subprocess.run(
                [cli, "compress-z", self.vcfc_path, z_path, str(version)], check=True
            )

        def single(ref, pos):
            return subprocess.run(
                [cli, "query-z", z_path, f"{ref}:{pos}-{pos}"],
                capture_output=True,
                check=True,
            ).stdout

        def range_(ref, start, end):
            return subprocess.run(
                [cli, "query-z", z_path, f"{ref}:{start}-{end}"],
                capture_output=True,
                check=True,
            ).stdout

        return PreparedScheme(f"vcfz-v{version}", single, range_, z_path)

    # -- external schemes (tabix / bcftools) ------------------------------

    def tabix_bgzip(self, force_rebuild: bool = False) -> PreparedScheme | None:
        bgzip_r, tabix_r = _tool("bgzip"), _tool("tabix")
        if not (bgzip_r and tabix_r):
            return None
        bgzip, _ = bgzip_r
        tabix, backend = tabix_r
        gz = os.path.join(self.workdir, self.dataset.name + ".vcf.gz")
        if not os.path.exists(gz):
            with open(gz, "wb") as f:
                subprocess.run(
                    [bgzip, "-c", self.dataset.vcf_path], stdout=f, check=True
                )
            subprocess.run([tabix, "-p", "vcf", gz], check=True)
        elif force_rebuild:
            # re-time INDEX creation only (bgzip compression is prep, like
            # the reference harness's tabix timing, command.py:85-93)
            if os.path.exists(gz + ".tbi"):
                os.unlink(gz + ".tbi")
            subprocess.run([tabix, "-p", "vcf", gz], check=True)

        def single(ref, pos):
            return subprocess.run(
                [tabix, gz, f"{ref}:{pos}-{pos}"], capture_output=True, check=True
            ).stdout

        def range_(ref, start, end):
            return subprocess.run(
                [tabix, gz, f"{ref}:{start}-{end}"], capture_output=True, check=True
            ).stdout

        return PreparedScheme("tabix-bgzip", single, range_, gz + ".tbi", backend)

    def tabix_bcf(self, force_rebuild: bool = False) -> PreparedScheme | None:
        bcftools_r = _tool("bcftools")
        if not bcftools_r:
            return None
        bcftools, backend = bcftools_r
        bcf = os.path.join(self.workdir, self.dataset.name + ".bcf")
        if not os.path.exists(bcf):
            subprocess.run(
                [bcftools, "view", "-O", "b", "-o", bcf, self.dataset.vcf_path],
                check=True,
            )
            subprocess.run([bcftools, "index", bcf], check=True)
        elif force_rebuild:
            if os.path.exists(bcf + ".csi"):
                os.unlink(bcf + ".csi")
            subprocess.run([bcftools, "index", bcf], check=True)

        def single(ref, pos):
            return subprocess.run(
                [bcftools, "view", "-H", bcf, f"{ref}:{pos}-{pos}"],
                capture_output=True,
                check=True,
            ).stdout

        def range_(ref, start, end):
            return subprocess.run(
                [bcftools, "view", "-H", bcf, f"{ref}:{start}-{end}"],
                capture_output=True,
                check=True,
            ).stdout

        return PreparedScheme("tabix-bcf", single, range_, bcf + ".csi", backend)

    def build(
        self, name: str, force_rebuild: bool = False, **kw
    ) -> PreparedScheme | None:
        """force_rebuild re-creates the scheme's index artifact so repeated
        builds measure real work (the binned schemes always rebuild)."""
        if name.startswith("vcfc-binned-native"):
            return self.vcfc_binned_native(**kw)
        if name == "vcfc-manifest-native":
            return self.vcfc_manifest_native(force_rebuild)
        if name.startswith("vcfz-v"):
            return self.vcfz(version=int(name.split("-v")[1]), force_rebuild=force_rebuild)
        if name == "vcfz":
            return self.vcfz(**kw)
        if name.startswith("vcfc-binned"):
            return self.vcfc_binned(**kw)
        if name == "vcfc-sparse":
            return self.vcfc_sparse(force_rebuild)
        if name == "vcfc-sparse-external":
            return self.vcfc_sparse_external(force_rebuild)
        if name == "tabix-bgzip":
            return self.tabix_bgzip(force_rebuild)
        if name == "tabix-bcf":
            return self.tabix_bcf(force_rebuild)
        raise ValueError(f"unknown scheme {name}")
