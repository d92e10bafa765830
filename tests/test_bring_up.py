"""Device-independent pieces of running on a GPU host: the compile cache
location, the mesh routing budget, device reporting, and the host stages
that must not need matplotlib or scikit-learn."""

import builtins
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from mercat2_tpu.metrics.beta import compute_beta_diversity
from mercat2_tpu.parallel import count as pcount
from mercat2_tpu.report import figures as figs
from mercat2_tpu.utils import runtime


# -- compile cache ----------------------------------------------------------


def test_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    assert runtime.compilation_cache_dir() == str(tmp_path / "jc")


def test_cache_dir_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = runtime._CHECKOUT
    assert runtime.compilation_cache_dir() == str(repo / ".jax_cache")
    assert (repo / "mercat2_tpu").is_dir()
    assert runtime.compilation_cache_dir() == runtime.compilation_cache_dir()


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compilation_cache_sets_only_that_dir(monkeypatch, tmp_path,
                                                     env_set):
    """With the variable set, its directory is the one JAX is given; unset,
    the fixed checkout path is."""
    import jax

    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "e"))
        want = str(tmp_path / "e")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        (tmp_path / "pyproject.toml").write_text("")
        monkeypatch.setattr(runtime, "_CHECKOUT", tmp_path)
        want = str(tmp_path / ".jax_cache")
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    assert runtime.enable_compilation_cache() == want
    dirs = [v for n, v in calls if n == "jax_compilation_cache_dir"]
    assert dirs == [want]
    assert (tmp_path / want.rsplit("/", 1)[-1]).is_dir()


@pytest.mark.parametrize("where", ["installed", "unwritable"])
def test_no_cache_outside_a_writable_checkout(monkeypatch, tmp_path, capsys,
                                              where):
    """An installed package (no pyproject.toml beside it) or a checkout
    that cannot be written runs uncached, says so once, and creates
    nothing."""
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(runtime, "_CHECKOUT", tmp_path)
    if where == "unwritable":
        (tmp_path / "pyproject.toml").write_text("")
        monkeypatch.setattr(runtime.os, "access", lambda path, mode: False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    assert runtime.compilation_cache_dir() is None
    assert runtime.enable_compilation_cache() is None
    assert calls == []
    assert not (tmp_path / ".jax_cache").exists()
    assert capsys.readouterr().out.startswith("Compile cache off:")


# -- routing budget -----------------------------------------------------------


def _device(platform, stats):
    return SimpleNamespace(platform=platform, device_kind=f"{platform} dev",
                           memory_stats=lambda: stats)


def test_route_budget_is_share_of_bytes_limit():
    limit = 60 << 30
    dev = _device("gpu", {"bytes_limit": limit, "bytes_in_use": 0})
    assert pcount.route_hbm_budget(dev) == int(
        limit * pcount._ROUTE_MEMORY_SHARE)


def test_route_budget_cpu_without_limit_keeps_constant():
    assert pcount.route_hbm_budget(_device("cpu", None)) == \
        pcount._ROUTE_HBM_BUDGET


def test_route_budget_accelerator_without_limit_is_an_error():
    with pytest.raises(RuntimeError, match="no memory limit"):
        pcount.route_hbm_budget(_device("gpu", {}))


def test_route_budget_of_this_backend():
    """The test backend is the CPU, which reports no limit."""
    import jax

    assert pcount.route_hbm_budget(jax.devices()[0]) == \
        pcount._ROUTE_HBM_BUDGET


# -- device reporting ---------------------------------------------------------


def test_pipeline_prints_device_line(capsys):
    import jax

    from mercat2_tpu.pipeline import _print_devices

    _print_devices()
    line = capsys.readouterr().out.strip()
    assert line == ("Devices: platform=cpu device_kind=cpu "
                    f"count={len(jax.devices())}")


def test_resolve_mesh_does_not_swallow_device_errors(monkeypatch):
    import jax

    from mercat2_tpu.pipeline import _resolve_mesh

    def broken():
        raise RuntimeError("backend failed to start")

    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError, match="backend failed"):
        _resolve_mesh("auto")
    assert _resolve_mesh("off") is None


# -- host stages without optional packages -------------------------------------


def _hide_module(monkeypatch, name: str) -> None:
    """Make ``import name`` (and its submodules) raise ImportError."""
    real = builtins.__import__

    def fake(mod, *a, **kw):
        if mod == name or mod.startswith(name + "."):
            raise ImportError(f"No module named {name!r}")
        return real(mod, *a, **kw)

    for mod in list(sys.modules):
        if mod == name or mod.startswith(name + "."):
            monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", fake)


def _write_matrix(path, rows=5, cols=6, seed=0):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 9, size=(rows, cols))
    lines = ["sample\t" + "\t".join(f"K{j}" for j in range(cols))]
    lines += [f"s{i}\t" + "\t".join(str(v) for v in row)
              for i, row in enumerate(mat)]
    path.write_text("\n".join(lines) + "\n")
    return mat


def test_beta_tsvs_written_without_matplotlib(monkeypatch, tmp_path, capsys):
    _write_matrix(tmp_path / "T.tsv")
    _hide_module(monkeypatch, "matplotlib")
    done = compute_beta_diversity("x", tmp_path / "T.tsv", tmp_path / "b")
    out = capsys.readouterr().out
    assert "heatmaps skipped" in out
    assert "euclidean" in done and "braycurtis" in done
    assert (tmp_path / "b" / "euclidean-x.tsv").exists()
    assert not list((tmp_path / "b").glob("*.png"))
    # metrics that cannot be computed are still reported one by one
    assert "mahalanobis" not in done
    assert "Error with beta metric: Mahalanobis" in out


def test_pca_full_batch_without_sklearn(monkeypatch, tmp_path):
    _write_matrix(tmp_path / "T.tsv", rows=6, cols=12)
    _hide_module(monkeypatch, "sklearn")
    _hide_module(monkeypatch, "matplotlib")
    fig3d, _ = figs.plot_pca(tmp_path / "T.tsv", tmp_path / "pca")
    rows = (tmp_path / "pca" / "pca.tsv").read_text().splitlines()
    assert rows[0] == "sample\tPC1\tPC2\tPC3" and len(rows) == 7
    assert fig3d is not None


@pytest.mark.parametrize("shape", [(6, 40), (5, 700), (12, 30), (600, 20)])
def test_numpy_pca_matches_sklearn(shape):
    """Scores (signs included) and variance ratios equal scikit-learn's,
    whichever solver it picks for the shape."""
    sk = pytest.importorskip("sklearn.decomposition")
    x = np.random.default_rng(shape[0]).poisson(3, size=shape).astype(float)
    scores, ratio = figs.pca_full(x, 3)
    pca = sk.PCA(n_components=3)
    want = pca.fit_transform(x)
    np.testing.assert_allclose(scores, want, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(ratio, pca.explained_variance_ratio_,
                               rtol=1e-9, atol=1e-12)


def test_lowmem_pca_without_sklearn_fails_at_start(monkeypatch):
    _hide_module(monkeypatch, "sklearn")
    figs.require_pca_backend(None, 1000)  # full batch: numpy only
    with pytest.raises(SystemExit, match="scikit-learn"):
        figs.require_pca_backend(None, 1001)
    with pytest.raises(SystemExit, match="scikit-learn"):
        figs.require_pca_backend(True, 4)
