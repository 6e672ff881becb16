"""PyTorch port, visualizers: the similarity and FFT analytics against the
JAX package's on the same parameters (1e-6: float32 PE tables computed by
two frameworks, compared after the float64 cosine similarity / FFT) and
against the reference visualizer's golden fixture (the tolerances of
tests/test_viz.py); checkpoint introspection, discovery and .pth export
against the JAX package's on the same files; and both CLIs on the CPU in
every mode (PNGs written), with tolerant loading, the CPU refusal, and
their figures' data computed without matplotlib."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.utils import checkpoint as jckpt
from vit_rpe_rope_tpu.viz import introspect as jintrospect
from vit_rpe_rope_tpu.viz import rope_freq as jrope_freq
from vit_rpe_rope_tpu.viz import similarity as jsimilarity
from vit_rpe_rope_tpu_torch.cli import pe_similarity_visualizer as pe_cli
from vit_rpe_rope_tpu_torch.cli import rope_visualizer as rope_cli
from vit_rpe_rope_tpu_torch.utils import checkpoint
from vit_rpe_rope_tpu_torch.viz import introspect, rope_freq, similarity

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "viz_golden.npz")
TOL = 1e-6
CPU = "cpu"


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def rng_params(seed, *shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def assert_close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---- similarity analytics ----------------------------------------------------

@pytest.mark.parametrize("method,params,kw", [
    ("absolute", (1, 100, 16), dict(grid_size=8)),
    ("relative", (4, 129), dict(grid_size=8)),
    ("polynomial", (4,), dict(grid_size=6, num_heads=3)),
    ("polynomial", (3, 5), dict(grid_size=7)),
    ("rope-mixed", (2, 4, 8), dict(grid_size=8, head_idx=2)),
    ("rope-mixed", (2, 3, 8), dict(grid_size=5, compat_scramble=True)),
])
def test_similarity_matches_jax(method, params, kw):
    fn = {"absolute": "absolute_similarity",
          "relative": "relative_similarity",
          "polynomial": "polynomial_similarity",
          "rope-mixed": "rope_mixed_similarity"}[method]
    table = rng_params(len(params), *params)
    want, want_grid = getattr(jsimilarity, fn)(table, **kw)
    extra = {} if method == "absolute" else {"device": CPU}
    got, grid = getattr(similarity, fn)(table, **kw, **extra)
    assert grid == want_grid and got.dtype == np.float32
    assert_close(got, want)


@pytest.mark.parametrize("theta,grid", [(100.0, 8), (10.0, 6)])
def test_rope_axial_similarity_matches_jax(theta, grid):
    inv_freq = np.zeros(6, np.float32)  # only its length is read
    want, _ = jsimilarity.rope_axial_similarity(inv_freq, grid, theta)
    got, _ = similarity.rope_axial_similarity(inv_freq, grid, theta,
                                              device=CPU)
    assert_close(got, want)


def test_similarity_for_dispatch_matches_jax(tmp_path):
    """similarity_for on the PE state of one checkpoint per method, loaded
    by each package's introspection (rope modes drawn at min(grid, 8))."""
    for method in ("absolute", "relative", "polynomial", "rope-axial",
                   "rope-mixed"):
        path, _ = save_jax_ckpt(tmp_path, method, fname=f"{method}.npz",
                                img_size=48)
        jm = jintrospect.load_pe_model(path, method, grid_size=12,
                                       num_heads=4)
        tm = introspect.load_pe_model(path, method, grid_size=12,
                                      num_heads=4)
        want, wg = jsimilarity.similarity_for(jm, head_idx=1, num_heads=4)
        got, g = similarity.similarity_for(tm, head_idx=1, num_heads=4,
                                           device=CPU)
        assert g == wg == (8 if method.startswith("rope") else 12), method
        assert_close(got, want)
    assert_close(similarity.block_matrix(got, g),
                 jsimilarity.block_matrix(want, g))


def test_similarity_golden(golden):
    sim, g = similarity.absolute_similarity(golden["abs.table"], 8)
    np.testing.assert_allclose(sim, golden["abs.sim"], rtol=1e-4, atol=1e-5)
    sim, g = similarity.relative_similarity(golden["rel.table"], 8, CPU)
    assert g == 8
    np.testing.assert_allclose(sim, golden["rel.sim"], rtol=1e-4, atol=1e-5)
    sim, _ = similarity.polynomial_similarity(golden["poly.coeff"], 8,
                                              num_heads=4, device=CPU)
    np.testing.assert_allclose(sim, golden["poly.sim"], rtol=1e-4, atol=1e-4)
    inv = 1.0 / (100.0 ** (np.arange(8, dtype=np.float32) / 8))
    sim, _ = similarity.rope_axial_similarity(inv, 8, 100.0, device=CPU)
    np.testing.assert_allclose(sim, golden["axial.sim"], rtol=1e-4, atol=1e-5)
    # The reference visualizer inherits the (head, position) scramble.
    sim, _ = similarity.rope_mixed_similarity(
        golden["mixed.freqs"], 8, head_idx=1, compat_scramble=True,
        device=CPU)
    np.testing.assert_allclose(sim, golden["mixed.sim"], rtol=1e-4, atol=1e-5)


# ---- rope FFT analytics -------------------------------------------------------

@pytest.mark.parametrize("pattern", ["single", "double", "corner", "diagonal",
                                     "custom"])
def test_rope_fft_matches_jax(pattern):
    coords = ["1", "2", "3", "4", "9", "9"]
    pos = rope_freq.create_input_positions(pattern, 8, coords)
    np.testing.assert_array_equal(
        pos, jrope_freq.create_input_positions(pattern, 8, coords))
    axial = rope_freq.axial_freqs(32, 100.0, 8, device=CPU)
    for got, want in zip(axial, jrope_freq.axial_freqs(32, 100.0, 8)):
        assert_close(got, want)
    freqs = rng_params(7, 2, 4, 16)
    for compat in (False, True):
        mixed = rope_freq.mixed_freqs(32, 4, 10.0, 8, freqs_param=freqs,
                                      compat_scramble=compat, device=CPU)
        jmixed = jrope_freq.mixed_freqs(32, 4, 10.0, 8, freqs_param=freqs,
                                        compat_scramble=compat)
        for head in (0, 3):
            got = rope_freq.apply_rope_and_fft(pos, *mixed, head_idx=head)
            want = jrope_freq.apply_rope_and_fft(pos, *jmixed, head_idx=head)
            for g, w in zip(got, want):
                assert_close(g, w)
    for g, w in zip(rope_freq.apply_rope_and_fft(pos, *axial),
                    jrope_freq.apply_rope_and_fft(
                        pos, *jrope_freq.axial_freqs(32, 100.0, 8))):
        assert_close(g, w)


@pytest.mark.parametrize("pattern", ["single", "diagonal"])
def test_rope_fft_golden(golden, pattern):
    pos = rope_freq.create_input_positions(pattern, 8)
    np.testing.assert_array_equal(pos, golden[f"pat.{pattern}"])
    mag, rec = rope_freq.apply_rope_and_fft(
        pos, *rope_freq.axial_freqs(32, 100.0, 8, device=CPU))
    np.testing.assert_allclose(mag, golden[f"fft.axial.{pattern}.mag"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rec, golden[f"fft.axial.{pattern}.rec"],
                               rtol=1e-4, atol=1e-5)
    mixed = rope_freq.mixed_freqs(32, 4, 10.0, 8,
                                  freqs_param=golden["mixed.freqs"],
                                  compat_scramble=True, device=CPU)
    mag, rec = rope_freq.apply_rope_and_fft(pos, *mixed, head_idx=1)
    np.testing.assert_allclose(mag, golden[f"fft.mixed.{pattern}.mag"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rec, golden[f"fft.mixed.{pattern}.rec"],
                               rtol=1e-4, atol=1e-5)


def test_mixed_freqs_random_init_is_seeded():
    """Untrained rope-mixed frequencies come from a torch.Generator seeded
    with `seed` (the JAX package draws from PRNGKey(seed): by design the
    two differ); the same seed gives the same tables."""
    a = rope_freq.mixed_freqs(16, 2, 10.0, 4, seed=3, device=CPU)
    b = rope_freq.mixed_freqs(16, 2, 10.0, 4, seed=3, device=CPU)
    c = rope_freq.mixed_freqs(16, 2, 10.0, 4, seed=4, device=CPU)
    assert a[0].shape == (2, 16, 8)
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], c[0])


# ---- introspection, discovery, export ----------------------------------------

def save_jax_ckpt(tmp_path, pe_name, fname=None, img_size=32):
    cfg = JaxViTConfig(img_size=img_size, patch_size=4, in_chans=3,
                       embed_dim=96, depth=2, num_heads=4,
                       pos_encoding=pe_name, poly_shared_heads=False)
    params = jvit.init_params(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path / (fname or f"cifar10_{pe_name}_best.npz"))
    return jckpt.save(path, params, jvit.buffers(cfg),
                      aliases=jvit.reference_alias_keys(cfg)), cfg


def same_pe_model(got, want):
    for attr in ("method", "embed_dim", "num_heads", "head_dim",
                 "grid_size"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert sorted(got.params) == sorted(want.params)
    for key in want.params:
        np.testing.assert_array_equal(got.params[key], want.params[key])


@pytest.mark.parametrize("pe_name", ["absolute", "relative", "polynomial",
                                     "rope-axial", "rope-mixed"])
def test_load_pe_model_matches_jax_on_npz_and_pth(tmp_path, pe_name):
    npz, _ = save_jax_ckpt(tmp_path, pe_name)
    pth = checkpoint.export_torch(npz, str(tmp_path / f"{pe_name}.pth"))
    other = str(tmp_path / f"mnist_{pe_name}_best.npz")
    os.rename(save_jax_ckpt(tmp_path, pe_name, fname="x.npz")[0], other)
    for path in (npz, pth, other):
        for grid in (14, 5):
            same_pe_model(
                introspect.load_pe_model(path, pe_name, grid_size=grid,
                                         num_heads=3),
                jintrospect.load_pe_model(path, pe_name, grid_size=grid,
                                          num_heads=3))
    # 'cifar10' in the filename pins the grid to 8 (reference quirk).
    assert introspect.load_pe_model(npz, pe_name, grid_size=14,
                                    num_heads=4).grid_size == 8


@pytest.mark.parametrize("pe_name", ["rope-axial", "rope-mixed"])
def test_pe_only_checkpoint_recovers_width_as_jax(tmp_path, pe_name):
    path, _ = save_jax_ckpt(tmp_path, pe_name)
    state = checkpoint.load_state(path)
    stripped = str(tmp_path / f"cifar10_{pe_name}_pe_only.npz")
    np.savez(stripped, **{k: v for k, v in state.items()
                          if k.startswith("pos_embed.")})
    got = introspect.load_pe_model(stripped, pe_name, num_heads=4)
    same_pe_model(got, jintrospect.load_pe_model(stripped, pe_name,
                                                 num_heads=4))
    assert got.embed_dim == 96 and got.head_dim == 24


def test_wrong_method_raises_the_helpful_error(tmp_path):
    path, _ = save_jax_ckpt(tmp_path, "rope-axial")
    with pytest.raises(ValueError, match="looks like \\['rope-axial'\\]"):
        introspect.load_pe_model(path, "rope-mixed")
    with pytest.raises(ValueError, match="Unsupported model_config"):
        introspect.load_pe_model(path, "none")


def test_discovery_and_find_checkpoint_match_jax(tmp_path):
    save_jax_ckpt(tmp_path, "relative")
    npz, _ = save_jax_ckpt(tmp_path, "rope-axial")
    checkpoint.export_torch(npz)  # an .npz and a .pth: .npz preferred
    mixed, _ = save_jax_ckpt(tmp_path, "rope-mixed")
    pth = checkpoint.export_torch(mixed)
    os.remove(mixed)  # only the .pth is left
    methods = ["absolute", "relative", "rope-axial", "rope-mixed"]
    found = introspect.discover_checkpoints(str(tmp_path), methods)
    assert found == jintrospect.discover_checkpoints(str(tmp_path), methods)
    assert found == {"relative": str(tmp_path / "cifar10_relative_best.npz"),
                     "rope-axial": npz, "rope-mixed": pth}
    for method in methods:
        assert checkpoint.find_checkpoint(str(tmp_path), "cifar10", method) \
            == jckpt.find_checkpoint(str(tmp_path), "cifar10", method)


@pytest.mark.parametrize("pe_name", ["relative", "rope-mixed"])
def test_export_torch_matches_jax(tmp_path, pe_name):
    npz, cfg = save_jax_ckpt(tmp_path, pe_name)
    state = dict(np.load(npz))
    state["__epoch"] = np.asarray(3)  # extras are dropped
    np.savez(npz, **state)
    got = torch.load(checkpoint.export_torch(npz, str(tmp_path / "a.pth")),
                     weights_only=True)
    want = torch.load(jckpt.export_torch(npz, str(tmp_path / "b.pth")),
                      weights_only=True)
    assert set(got) == set(want) and "__epoch" not in got
    assert any(".attn.pos_encoding." in k for k in got)  # aliases kept
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert checkpoint.export_torch(npz) == npz[:-4] + ".pth"


# ---- CLIs ---------------------------------------------------------------------

def pngs(path):
    return sorted(p for p in os.listdir(path) if p.endswith(".png"))


def test_pe_similarity_cli_random_init(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no ./checkpoints: random init
    pe_cli.main(["--methods", "relative", "rope-axial", "--grid_size", "4",
                 "--dim", "32", "--num_heads", "2", "--dpi", "50",
                 "--output_dir", "out", "--device", "cpu"])
    names = pngs(tmp_path / "out")
    assert len(names) == 4  # grid + compact, two methods
    assert any(n.startswith("pe_similarity_grid_random_init_relative")
               for n in names)


def test_pe_similarity_cli_load_model(tmp_path):
    path, _ = save_jax_ckpt(tmp_path, "polynomial",
                            fname="mnist_polynomial_best.npz", img_size=16)
    pe_cli.main(["--load_model", "--model_path", path, "--model_config",
                 "polynomial", "--grid_size", "4", "--dpi", "50",
                 "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    names = pngs(tmp_path / "out")
    assert any(n.startswith(
        "pe_similarity_compact_mnist_polynomial_best_polynomial")
        for n in names)
    assert any(n.startswith("pe_similarity_grid_mnist_polynomial_best")
               for n in names)


def test_pe_similarity_cli_auto_discovery(tmp_path, monkeypatch, capsys):
    (tmp_path / "checkpoints").mkdir()
    save_jax_ckpt(tmp_path / "checkpoints", "relative")
    npz, _ = save_jax_ckpt(tmp_path / "checkpoints", "rope-mixed")
    checkpoint.export_torch(npz)
    os.remove(npz)
    monkeypatch.chdir(tmp_path)
    pe_cli.main(["--dpi", "50", "--device", "cpu"])
    assert "Auto-discovered checkpoints: ['relative', 'rope-mixed']" in \
        capsys.readouterr().out
    assert [n.startswith("pe_model_comparison")
            for n in pngs(tmp_path / "visualizations")] == [True]


def test_pe_similarity_comparison_skips_bad_model(tmp_path, capsys):
    good, _ = save_jax_ckpt(tmp_path, "relative")
    bad, _ = save_jax_ckpt(tmp_path, "rope-axial")
    pe_cli.main(["--compare_models", "--model_paths", good, bad,
                 "--model_configs", "relative", "polynomial",
                 "--dpi", "50", "--output_dir", str(tmp_path / "out"),
                 "--device", "cpu"])
    assert "Skipping polynomial." in capsys.readouterr().out
    assert any(n.startswith("pe_model_comparison")
               for n in pngs(tmp_path / "out"))


def test_rope_visualizer_cli_default_and_thetas(tmp_path):
    rope_cli.main(["--patterns", "single", "custom", "--custom_pattern",
                   "1,2", "--grid_size", "8", "--dim", "16", "--num_heads",
                   "2", "--head_indices", "0", "1", "--dpi", "50",
                   "--compare_thetas", "--theta_values", "10", "100",
                   "--output_dir", str(tmp_path), "--device", "cpu"])
    names = pngs(tmp_path)
    assert any(n.startswith("rope_freq_single") for n in names)
    assert any(n.startswith("rope_freq_custom") for n in names)
    assert any(n.startswith("rope_freq_theta_comparison") for n in names)


@pytest.mark.parametrize("pe_name", ["rope-axial", "rope-mixed"])
def test_rope_visualizer_cli_load_model(tmp_path, pe_name):
    path, _ = save_jax_ckpt(tmp_path, pe_name, f"mnist_{pe_name}_best.npz")
    rope_cli.main(["--load_model", "--model_path", path, "--model_config",
                   pe_name, "--patterns", "corner", "--dpi", "50",
                   "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert any(n.startswith("rope_freq_trained_corner")
               for n in pngs(tmp_path / "out"))


def test_rope_visualizer_compare_models(tmp_path, capsys):
    axial, _ = save_jax_ckpt(tmp_path, "rope-axial")
    mixed, _ = save_jax_ckpt(tmp_path, "rope-mixed")
    rope_cli.main(["--compare_models", "--axial_model_path", axial,
                   "--mixed_model_path", checkpoint.export_torch(mixed),
                   "--patterns", "corner", "--dpi", "50",
                   "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert any(n.startswith("rope_freq_models_corner")
               for n in pngs(tmp_path / "out"))
    bad, _ = save_jax_ckpt(tmp_path, "relative")  # not a rope-mixed model
    rope_cli.main(["--compare_models", "--axial_model_path", axial,
                   "--mixed_model_path", bad, "--patterns", "single",
                   "--grid_size", "8", "--dim", "16", "--num_heads", "2",
                   "--dpi", "50", "--output_dir", str(tmp_path / "out2"),
                   "--device", "cpu"])
    assert "Skipping rope-mixed." in capsys.readouterr().out
    assert pngs(tmp_path / "out2")


@pytest.mark.parametrize("cli,argv", [
    (pe_cli, ["--methods", "relative", "--grid_size", "4", "--dim", "32",
              "--num_heads", "2"]),
    (rope_cli, ["--patterns", "single"])])
def test_visualizers_refuse_the_cpu_unless_asked(cli, argv, tmp_path,
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(argv + ["--output_dir", "out", "--dpi", "50"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        similarity.relative_similarity(rng_params(0, 2, 9), 2)
    assert not (tmp_path / "out").exists()


def test_figures_need_no_matplotlib(tmp_path):
    """figures(args), what main() draws, is computed without matplotlib
    (a machine without it still runs the device work); main() then fails
    at the first figure."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "from vit_rpe_rope_tpu_torch.cli import pe_similarity_visualizer as p\n"
        "from vit_rpe_rope_tpu_torch.cli import rope_visualizer as r\n"
        "argv = ['--methods', 'relative', 'rope-mixed', '--grid_size', '4',\n"
        "        '--dim', '32', '--num_heads', '2', '--device', 'cpu']\n"
        "kinds = [k for k, _ in p.figures(p.get_args(argv))]\n"
        "assert kinds == ['grid', 'compact'] * 2, kinds\n"
        "kinds = [k for k, _ in r.figures(r.get_args(\n"
        "    ['--compare_thetas', '--device', 'cpu']))]\n"
        "assert kinds == ['pattern'] * 4 + ['thetas'], kinds\n"
        "try:\n"
        "    r.main(['--patterns', 'single', '--device', 'cpu'])\n"
        "except ImportError:\n"
        "    print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
