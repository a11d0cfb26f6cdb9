"""Formats layer tests: .bed round-trip, .phen preprocessing, group files,
history/csv/mlma writers (layouts from reference xfiles.hpp:13-38,
xfiles.cpp:6-47, bayes.cpp:223-254)."""

import os
import struct

import numpy as np
import pytest

from gmrm_tpu.config import Options, OptionsError
from gmrm_tpu.io.bed import (
    read_bed, write_bed, unpack_codes, decode_planes, bed_bytes_per_marker,
)
from gmrm_tpu.io.grouping import read_dim, read_group_index
from gmrm_tpu.io.phen import read_phen
from gmrm_tpu.io.writers import (
    HistoryWriter, read_history, format_csv_record, format_mlma_line,
    MLMA_LINE_LEN,
)


def test_bed_roundtrip(tmp_path, rng):
    n, m = 101, 7  # N % 4 != 0 exercises the padding path
    codes = rng.integers(0, 4, size=(m, n)).astype(np.uint8)
    path = str(tmp_path / "t.bed")
    write_bed(path, codes)
    assert os.path.getsize(path) == 3 + m * bed_bytes_per_marker(n)
    bed = read_bed(path, n, m)
    got = unpack_codes(bed, n)
    np.testing.assert_array_equal(got, codes)


def test_bed_decode_semantics():
    # One byte packing codes [0, 1, 2, 3] -> a = [2,0,1,0], b = [1,0,1,1]
    # (reference LUT generator mk_lut.cpp:25-65).
    byte = np.array([[0b11100100]], dtype=np.uint8)
    codes = unpack_codes(byte, 4)
    np.testing.assert_array_equal(codes[0], [0, 1, 2, 3])
    a, b = decode_planes(codes)
    np.testing.assert_array_equal(a[0], [2.0, 0.0, 1.0, 0.0])
    np.testing.assert_array_equal(b[0], [1.0, 0.0, 1.0, 1.0])


def test_phen_center_scale(tmp_path):
    vals = [1.0, 2.0, None, 4.0, 5.0]
    p = tmp_path / "x.phen"
    with open(p, "w") as fh:
        for i, v in enumerate(vals):
            fh.write(f"{i} {i} {'NA' if v is None else v}\n")
    ph = read_phen(str(p), 5)
    assert ph.nas == 1 and ph.nonas == 4
    # Reference: center by non-NA mean, scale so sum eps^2 == nonas-1,
    # eps = 0 at NAs (phenotype.cpp:647-667).
    assert ph.epsilon0[2] == 0.0
    obs = ph.epsilon0[ph.mask]
    np.testing.assert_allclose(obs.sum(), 0.0, atol=1e-12)
    np.testing.assert_allclose((obs ** 2).sum(), ph.nonas - 1, rtol=1e-12)
    # NA mask padding: N=5 -> last 3 slots of the 8-slot padded vector are 0.
    nav = ph.na_vector_padded()
    assert nav.shape[0] == 8
    np.testing.assert_array_equal(nav, [1, 1, 0, 1, 1, 0, 0, 0])


def test_group_files(tmp_path):
    grm = tmp_path / "g.grm"
    grm.write_text("0.0 0.0001 0.001\n0.0 0.01 0.1\n")
    opt = Options(group_mixture_file=str(grm))
    opt.load_group_mixtures()
    assert opt.n_groups == 2 and opt.n_mixtures == 3
    np.testing.assert_allclose(opt.cvai[0], [0.0, 10000.0, 1000.0])

    bad = tmp_path / "bad.grm"
    bad.write_text("0.1 0.2\n")
    with pytest.raises(OptionsError):
        Options(group_mixture_file=str(bad)).load_group_mixtures()
    bad.write_text("0.0 0.2 0.1\n")
    with pytest.raises(OptionsError):
        Options(group_mixture_file=str(bad)).load_group_mixtures()

    gri = tmp_path / "g.gri"
    gri.write_text("rs1 0\nrs2 1\nrs3 1\n")
    g = read_group_index(str(gri), 2)
    np.testing.assert_array_equal(g, [0, 1, 1])
    with pytest.raises(IOError):
        read_group_index(str(gri), 1)


def test_dim(tmp_path):
    d = tmp_path / "t.dim"
    d.write_text("123 456\n")
    assert read_dim(str(d)) == (123, 456)


def test_history_layout(tmp_path, rng):
    """Byte-level check of the .bet 'h1' layout (xfiles.hpp:13-38)."""
    mtot = 10
    path = str(tmp_path / "t.bet")
    w = HistoryWriter(path, mtot, "f8")
    rec0 = rng.normal(size=mtot)
    rec1 = rng.normal(size=mtot)
    w.write_record(5, rec0)
    # Sharded write: two slices of the same record.
    w.write_record(10, rec1[:6], start=0, rec=1)
    w.write_record(10, rec1[6:], start=6, rec=1)

    raw = open(path, "rb").read()
    assert struct.unpack("<I", raw[:4])[0] == mtot
    assert struct.unpack("<I", raw[4:8])[0] == 5
    np.testing.assert_array_equal(
        np.frombuffer(raw[8:8 + 80], np.float64), rec0
    )
    off = 4 + (4 + 80)
    assert struct.unpack("<I", raw[off:off + 4])[0] == 10

    iters, data = read_history(path, "f8")
    np.testing.assert_array_equal(iters, [5, 10])
    np.testing.assert_allclose(data[1], rec1)


def test_csv_format():
    row = format_csv_record(
        3, np.array([0.1, 0.2]), 0.7, 42,
        np.array([[0.5, 0.25, 0.25], [0.9, 0.05, 0.05]]),
    )
    assert row.startswith("    3,    2, ")
    assert row.endswith("\n")
    fields = row.strip().split(",")
    # iter, G, sigmaG*2, sigmaE, h2, m0, G, K, pi*6
    assert len(fields) == 2 + 2 + 5 + 6
    h2 = float(fields[5])
    np.testing.assert_allclose(h2, 0.3 / (0.7 + 0.3), rtol=1e-12)
    assert int(fields[6]) == 42


def test_mlma_line():
    line = format_mlma_line("rs123", 7, 9, 0.1, -1.5, 0.2, 0.97)
    assert len(line) == MLMA_LINE_LEN
    toks = line.split()
    assert toks[0] == "rs123" and toks[1] == "7" and toks[2] == "9"


def test_sim_outputs(sim_small):
    n, m = read_dim(sim_small.dim)
    assert (n, m) == (402, 96)
    bed = read_bed(sim_small.bed, n, m)
    assert bed.shape == (m, bed_bytes_per_marker(n))
    ph = read_phen(sim_small.phens[0], n)
    assert ph.nas > 0
    codes = unpack_codes(bed, n)
    a, _ = decode_planes(codes)
    # Binomial(2, 0.4) dosages -> mean dosage near 0.8
    assert 0.6 < a.mean() < 1.0


def test_phen_malformed_agrees_native_and_numpy(tmp_path):
    """Malformed .phen lines must fail identically (IOError) whether the
    native parser or the numpy fallback handles them."""
    import pytest
    from gmrm_tpu.io.phen import read_phen
    from gmrm_tpu.io import native as nat

    for i, bad in enumerate(["F1 I1\n", "F1 I1 1.5x\n", "F1 I1 abc\n"]):
        p = tmp_path / f"bad{i}.phen"
        p.write_text("F0 I0 1.0\n" + bad)
        with pytest.raises(IOError):
            read_phen(str(p), 2)
        if nat.have_native():
            with pytest.raises(IOError):
                nat.native_parse_phen(str(p), 2)

    ok = tmp_path / "ok.phen"
    ok.write_text("F0 I0 1.5\nF1 I1 NA\nF2 I2 -2.0\n")
    ph = read_phen(str(ok), 3)
    assert ph.nas == 1 and ph.nonas == 2


def test_history_truncate_to(tmp_path):
    import numpy as np
    from gmrm_tpu.io.writers import HistoryWriter, read_history

    p = str(tmp_path / "x.bet")
    w = HistoryWriter(p, 5, "f8")
    for r in range(4):
        w.write_record(r + 1, np.full(5, float(r)))
    w2 = HistoryWriter.open_existing(p, 5, "f8")
    w2.truncate_to(2)
    iters, data = read_history(p, "f8")
    assert list(iters) == [1, 2]
    assert data.shape == (2, 5)


def test_interleave_roundtrip(sim_small):
    """Block-interleaved marker storage (runner.interleave_order): stored
    rows recover the original order through inv_order, group ids follow
    their markers, and adjacent original markers land in different
    blocks."""
    import numpy as np
    from gmrm_tpu.config import Options
    from gmrm_tpu.runner import load_data

    opt = Options(bed_file=sim_small.bed, dim_file=sim_small.dim,
                  phen_files=sim_small.phens,
                  group_index_file=sim_small.gri,
                  group_mixture_file=sim_small.grm, block_size=16)
    opt.load_group_mixtures()
    plain = load_data(opt, interleave=False)
    inter = load_data(opt, interleave=True)
    m = plain.m_local
    iv = inter.inv_order
    assert iv is not None and plain.inv_order is None
    np.testing.assert_array_equal(inter.bed[:m][iv], plain.bed[:m])
    np.testing.assert_array_equal(inter.group_of[:m][iv],
                                  plain.group_of[:m])
    # adjacent original markers are in different blocks
    B = opt.block_size
    nb = plain.m_pad // B
    pos = iv                      # storage row of original marker j
    blocks_of = pos // B
    same_block_adjacent = np.mean(blocks_of[:-1] == blocks_of[1:])
    assert same_block_adjacent < 1.0 / max(nb - 1, 1) + 0.1


def test_chunked_ld_simulator_matches_inmemory(tmp_path, monkeypatch):
    """The chunked (large-M) generator now streams the AR(1)-copula LD
    chain: with the in-memory limit shrunk, the
    chunked path must write the IDENTICAL .bed as the in-memory path
    (the latent chain is Markov, so chunking cannot change the draws)."""
    import gmrm_tpu.io.sim as sim_mod

    kw = dict(n=120, m=300, n_traits=1, n_causal=32, h2=0.5,
              n_groups=1, na_rate=0.0, seed=31, ld_rho=0.9)
    a = sim_mod.simulate(str(tmp_path / "mem"), **kw)
    monkeypatch.setattr(sim_mod, "INMEM_LIMIT", 120 * 64)  # ~5 chunks
    b = sim_mod.simulate(str(tmp_path / "chunk"), **kw)
    assert open(a.bed, "rb").read() == open(b.bed, "rb").read()
    # adjacent-marker LD is actually present in the chunked output
    from gmrm_tpu.io.bed import read_bed, unpack_codes, decode_planes
    bed = read_bed(b.bed, 120, 300)
    codes = unpack_codes(bed, 4 * bed.shape[1])
    av, _ = decode_planes(codes)
    x = av[:, :120].astype(np.float64)
    r2 = np.mean([np.corrcoef(x[j], x[j + 1])[0, 1] ** 2
                  for j in range(0, 299, 7)])
    assert r2 > 0.4
