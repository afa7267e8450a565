"""The port's full-scale fixture and latent tools against the JAX package's:
the same seed gives the same pixels and latents bit for bit, the contact
lists written without h5py are byte-equal to what the port's data module
extracts from the JAX tool's .mcool, and the latent target built from them
equals the JAX tool's."""
import os

import numpy as np
import pytest

from hicdiff_tpu_torch.data.datamodule import GSE130711Module as PortModule
from tools import latent_target as jax_latent
from tools import make_fullscale_fixture as jax_fix
from tools import torch_latent_target as port_latent
from tools import torch_make_fullscale_fixture as port_fix

BINS = [300, 280, 260]  # chromosome 1 reaches past the 257-bin band


def test_bin_table_and_band_match_the_jax_tool():
    assert port_fix.HG19_BINS_40KB == jax_fix.HG19_BINS_40KB
    assert port_fix.PATCH_BAND == jax_fix.PATCH_BAND == 257


@pytest.mark.parametrize("band", [257, 64])
def test_band_pixels_bit_equal_and_latent_draws_nothing(band):
    rj, rp, rl = (np.random.default_rng(5) for _ in range(3))
    lat_j, lat_p = [], []
    ref = jax_fix.band_pixels(400, rj, band=band, latent_out=lat_j)
    got = port_fix.band_pixels(400, rp, band=band, latent_out=lat_p)
    plain = port_fix.band_pixels(400, rl, band=band)  # no latent captured
    for a, b, c in zip(ref, got, plain):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    np.testing.assert_array_equal(lat_j[0], lat_p[0])
    assert lat_p[0].shape == (400, band)
    # the streams stand at the same place afterwards
    assert rj.integers(1 << 30) == rp.integers(1 << 30) == rl.integers(1 << 30)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The JAX tool's .mcool (and latents) and the port tool's contact lists
    (and latents and weights) from one seed."""
    pytest.importorskip("h5py")
    tmp = tmp_path_factory.mktemp("fullscale")
    mcool = str(tmp / "jax" / "Datasets" / "Human" / "cell1_synth.mcool")
    os.makedirs(os.path.dirname(mcool))
    jax_fix.make_fullscale(mcool, bins_per_chrom=BINS, seed=3, latent_dir=str(tmp / "jax_lat"))
    cdir = port_fix.constraints_dir(str(tmp / "port"), sigma=0.1, percentile=99.99)
    nb, npx = port_fix.make_fullscale(cdir, bins_per_chrom=BINS, seed=3,
                                      latent_dir=str(tmp / "port_lat"))
    assert nb == sum(BINS) and npx > 0
    return tmp, mcool


def test_constraints_byte_equal_to_extraction_from_jax_mcool(fixtures):
    from hicdiff_tpu_torch.data.mcool import McoolFile

    tmp, mcool = fixtures
    dm = PortModule(single_cell=True, root=str(tmp / "jax"), sigma_0=0.1, deg="deno",
                    n_chroms=len(BINS))
    dm.extract_constraint_mats()
    port_dir = port_fix.constraints_dir(str(tmp / "port"))
    assert port_dir.endswith(os.path.join("DataFull_Human_cell1_40000_deno_0.1_p99.99",
                                          "Constraints"))
    assert os.path.relpath(port_dir, str(tmp / "port")) == os.path.relpath(
        os.path.join(dm.dirname, "Constraints"), str(tmp / "jax"))
    names = sorted(os.listdir(os.path.join(dm.dirname, "Constraints")))
    assert names == sorted(os.listdir(port_dir)) and len(names) == 2 * len(BINS)
    for name in names:
        with open(os.path.join(dm.dirname, "Constraints", name), "rb") as f:
            want = f.read()
        with open(os.path.join(port_dir, name), "rb") as f:
            assert f.read() == want, name
    mc = McoolFile(mcool, 40000)
    for i in range(len(BINS)):
        np.testing.assert_array_equal(
            np.load(tmp / "port_lat" / f"weights_chr{i + 1}.npy"), mc.weights(f"chr{i + 1}"))
        np.testing.assert_array_equal(np.load(tmp / "port_lat" / f"latent_chr{i + 1}.npy"),
                                      np.load(tmp / "jax_lat" / f"latent_chr{i + 1}.npy"))


def test_latent_npy_equals_the_jax_tools(fixtures):
    tmp, mcool = fixtures
    dm = PortModule(single_cell=True, root=str(tmp / "port"), sigma_0=0.1, deg="deno",
                    n_chroms=len(BINS), batch_size=16)
    dm.prepare_data()
    dm.setup("all")
    ds = dm.test_set
    qdirs = {}
    for side in ("jax", "port", "port_mcool"):
        qdirs[side] = q = str(tmp / f"quartet_{side}")
        os.makedirs(q)
        np.save(f"{q}/target", ds.target)
        np.save(f"{q}/inds", ds.info)
    want = jax_latent.build_latent_npy(qdirs["jax"], dm.dirname, mcool, str(tmp / "jax_lat"),
                                       percentile=99.99)
    got = port_latent.build_latent_npy(qdirs["port"], dm.dirname, str(tmp / "port_lat"),
                                       percentile=99.99)
    via_mcool = port_latent.build_latent_npy(qdirs["port_mcool"], dm.dirname,
                                             str(tmp / "port_lat"), percentile=99.99,
                                             mcool=mcool)
    ref = np.load(f"{qdirs['jax']}/latent.npy")
    assert ref.shape == ds.target.shape
    for side in ("port", "port_mcool"):
        np.testing.assert_array_equal(np.load(f"{qdirs[side]}/latent.npy"), ref)
    for info in (got, via_mcool):
        for k in ("n_patches", "chromosomes", "corr_latent_target", "speckle_rms"):
            assert info[k] == want[k], k
    assert got["corr_latent_target"] > 0.6
    # a latent of another seed is refused
    bad = str(tmp / "lat_bad")
    port_fix.make_fullscale(str(tmp / "bad_constraints"), bins_per_chrom=[300, 200, 260],
                            seed=4, latent_dir=bad)
    with pytest.raises(ValueError):
        port_latent.build_latent_npy(qdirs["port"], dm.dirname, bad, percentile=99.99)


def test_cli_writes_the_cache_the_trainer_reads(tmp_path, capsys):
    port_fix.main(["--root", str(tmp_path), "--bins", "80", "--band", "32", "--latent-dir",
                   str(tmp_path / "lat")])
    assert "1760 bins" in capsys.readouterr().out
    dm = PortModule(single_cell=True, root=str(tmp_path), sigma_0=0.1)
    for c in (1, 22):
        assert os.path.exists(os.path.join(dm.dirname, "Constraints", f"chrom_{c}_40000.txt"))
        assert np.load(tmp_path / "lat" / f"latent_chr{c}.npy").shape == (80, 32)
