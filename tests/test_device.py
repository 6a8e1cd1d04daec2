"""The capability decision (exonerate_tpu/device.py), the compile-cache
rule, the fixture module that rebuilds inputs from the repo, and the
rows tier's exact score planes."""
from __future__ import annotations

import os

import numpy as np
import pytest

import exonerate_tpu
from exonerate_tpu import device
from exonerate_tpu.engine import optimal
from exonerate_tpu.engine.region import Region

from benchmarks import fixtures


@pytest.fixture
def backend(monkeypatch):
    """Pretend JAX's default backend is the given platform."""
    import jax

    def set_(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
    monkeypatch.delenv("EXONERATE_TPU_SDP", raising=False)
    return set_


@pytest.mark.parametrize("plat,tier,exhaustive,unroll,fold", [
    ("gpu", "device", True, 4, 2),
    ("cpu", "native", False, 1, 1),
])
def test_platform_decisions(backend, plat, tier, exhaustive, unroll,
                            fold):
    backend(plat)
    assert device.platform() == plat
    assert device.accelerator() is (plat == "gpu")
    assert device.sdp_tier() == tier
    assert device.exhaustive_on_device() is exhaustive
    assert device.wavefront_unroll() == unroll
    assert device.sdp_fold() == fold


@pytest.mark.parametrize("plat", ["rocm", "METAL", "neuron"])
def test_unknown_platform_is_an_error(backend, plat):
    backend(plat)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        device.platform()
    with pytest.raises(RuntimeError):
        device.sdp_tier()


@pytest.mark.parametrize("plat", ["gpu", "cpu"])
@pytest.mark.parametrize("forced", ["device", "native", "python"])
def test_forced_sdp_tier(backend, monkeypatch, plat, forced):
    backend(plat)
    monkeypatch.setenv("EXONERATE_TPU_SDP", forced)
    assert device.sdp_tier() == forced


def test_bad_sdp_tier_is_an_error(backend, monkeypatch):
    backend("gpu")
    monkeypatch.setenv("EXONERATE_TPU_SDP", "kernel")
    with pytest.raises(ValueError, match="EXONERATE_TPU_SDP"):
        device.sdp_tier()


def test_describe_reports_the_devices():
    d = device.describe()
    assert d["platform"] == "cpu" and d["count"] >= 1 and d["kind"]


@pytest.mark.parametrize("plat,native_above_threshold", [
    ("gpu", False), ("cpu", True)])
def test_exhaustive_routing(backend, plat, native_above_threshold):
    """Above the native-cell threshold an accelerator takes unmasked
    exhaustive DP; masked re-runs and small jobs stay native."""
    backend(plat)
    big = Region(0, 0, 2000, 2000)
    small = Region(0, 0, 500, 500)
    assert optimal._prefer_native(small)
    assert optimal._prefer_native(big) is native_above_threshold
    assert optimal._prefer_native(big, masked=True)


@pytest.fixture
def jax_cache_config():
    """Restore JAX's compile-cache settings after the test."""
    import jax
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield jax.config
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      saved[1])


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   jax_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert exonerate_tpu.enable_compilation_cache() == str(tmp_path)
    assert jax_cache_config.jax_compilation_cache_dir == str(tmp_path)
    assert jax_cache_config.jax_persistent_cache_min_compile_time_secs \
        == 0.2


def test_compile_cache_fixed_path_in_checkout(monkeypatch,
                                              jax_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(fixtures.REPO, ".jax_cache")
    assert exonerate_tpu.enable_compilation_cache() == want
    assert exonerate_tpu.compilation_cache_dir() == want
    assert jax_cache_config.jax_compilation_cache_dir == want
    assert jax_cache_config.jax_persistent_cache_min_compile_time_secs \
        == 0.2


def test_fixture_calm_matches_committed_copies():
    """The rebuilt CALM cDNA is the soft-masked golden copy with its
    case restored, under the header the translate golden shows."""
    cdna = fixtures.calm_cdna()
    with open(os.path.join(fixtures.GOLDEN, "data", "calm_soft.fa")) as f:
        soft = "".join(ln.strip() for ln in f if not ln.startswith(">"))
    assert len(cdna) == 2175 and cdna == soft.upper()
    text = fixtures.corpus_texts()["cdna/calm.human.dna.fasta"]
    header = text.splitlines()[0]
    with open(os.path.join(fixtures.GOLDEN, "out",
                           "util_fastatranslate.txt")) as f:
        assert f.readline().startswith(header + ":[revcomp]")
    counts = {b: cdna.count(b) for b in "ACGT"}
    assert counts == {"A": 430, "C": 626, "G": 592, "T": 527}


def test_fixture_corpus_round_trips_all4():
    """The cDNA files concatenate back to all4.fa byte for byte, and
    each protein is its CDS translation without the stop codon."""
    texts = fixtures.corpus_texts()
    cdnas = "".join(texts["cdna/" + c[0]] for c in fixtures.CORPUS)
    with open(os.path.join(fixtures.GOLDEN, "data", "all4.fa")) as f:
        assert cdnas == f.read()
    prot = fixtures.calm_protein()
    assert len(prot) == 149 and prot.startswith("MADQLTEEQIAEF")
    lengths = [len("".join(texts["protein/" + c[1]].splitlines()[1:]))
               for c in fixtures.CORPUS]
    assert lengths == [149, 1132, 393, 462]


def test_fixture_scan_inputs_are_seeded(tmp_path):
    a = fixtures.scan_inputs(str(tmp_path / "a"), n_genes=2, n_queries=3,
                             genome_mb=0.02)
    b = fixtures.scan_inputs(str(tmp_path / "b"), n_genes=2, n_queries=3,
                             genome_mb=0.02)
    for pa, pb in zip(a[:2], b[:2]):
        with open(pa) as fa, open(pb) as fb:
            assert fa.read() == fb.read()
    with open(a[0]) as f:
        assert f.read().count(">") == 3
    pf, tf, n = fixtures.p2g_inputs(str(tmp_path / "a"), n_queries=4,
                                    n_genes=2, genome_mb=0.02)
    assert n == 4 and open(tf).read() == open(a[1]).read()
    parts = fixtures.split_fasta(pf, 2)
    assert sum(open(p).read().count(">") for p in parts) == 4


@pytest.mark.parametrize("scale", [1, 1 << 11, 1 << 20])
def test_rows_factored_plane_exact(scale):
    """Integer score planes stay exact above 2^11 (where a TF32 matmul
    would round)."""
    from exonerate_tpu.engine import sdp_rows
    rng = np.random.default_rng(scale)
    table = rng.integers(-scale, scale + 1, (24, 25)).astype(np.int32)
    table[0, 0] = scale + 1
    t_idx = rng.integers(0, 25, 4097).astype(np.int32)
    got = np.asarray(sdp_rows.factored_plane(table, t_idx))
    assert got.dtype == np.int32
    assert np.array_equal(got, table[:, t_idx])


@pytest.mark.gpu
def test_rows_factored_plane_exact_on_gpu(gpu):
    """The same plane on the card, where a default-precision float
    matmul would run in TF32."""
    import jax
    from exonerate_tpu.engine import sdp_rows
    table = np.arange(24 * 25, dtype=np.int32).reshape(24, 25) * 4099
    t_idx = np.arange(8192, dtype=np.int32) % 25
    got = np.asarray(jax.jit(sdp_rows.factored_plane)(table, t_idx))
    assert np.array_equal(got, table[:, t_idx])


def test_rows_cache_key_tracks_sweeps(monkeypatch):
    from exonerate_tpu.engine import sdp_rows
    monkeypatch.delenv("EXONERATE_TPU_SDP_ROWS_SWEEPS", raising=False)
    monkeypatch.delenv("EXONERATE_TPU_SDP_ROWS_FIXED", raising=False)
    assert sdp_rows.sweep_settings() == (sdp_rows.MAX_SWEEPS, 0)
    monkeypatch.setenv("EXONERATE_TPU_SDP_ROWS_SWEEPS", "7")
    monkeypatch.setenv("EXONERATE_TPU_SDP_ROWS_FIXED", "3")
    assert sdp_rows.sweep_settings() == (7, 3)
