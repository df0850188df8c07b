"""The .udb kept in the checkout: a seed's first run builds it, a second
run of that seed loads it and reads the same, another seed builds its
own, and at most UDB_KEEP stay a configuration."""

from benchmark import gen

from conftest import tiny_spec


def _marks(out):
    line = next(x for x in out["log"] if x.startswith("set-up"))
    return line


def test_udb_is_built_once_a_seed(run_tiny, tmp_path, monkeypatch):
    spec = tiny_spec("gg99_v4.reads")
    drv = gen.plugin(spec["bench_dir"], "commands", "usearch_global")
    monkeypatch.setattr(drv, "UDB_CACHE", str(tmp_path))
    monkeypatch.setattr(drv, "UDB_KEEP", 2)
    first = run_tiny("gg99_v4.reads", seed=11, spec=spec)
    assert "index built" in _marks(first)
    again = run_tiny("gg99_v4.reads", seed=11, spec=tiny_spec(
        "gg99_v4.reads"))
    assert "index found" in _marks(again)
    assert again["result"]["correct"] is True
    assert again["result"]["checks"] == first["result"]["checks"]
    for seed in (12, 13):
        out = run_tiny("gg99_v4.reads", seed=seed, spec=tiny_spec(
            "gg99_v4.reads"))
        assert "index built" in _marks(out)
    kept = sorted(p.name.split("-")[1] for p in tmp_path.glob("*.udb"))
    assert kept == ["12", "13"]
    assert not list(tmp_path.glob("*.part"))
