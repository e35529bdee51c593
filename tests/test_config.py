"""RunConfig CLI / parameter-override tests."""

import json

from sphinxsys_jax.utils.config import RunConfig


def test_cli_flags():
    cfg = RunConfig.from_cli(["--relax", "--restart_step", "42",
                              "--set", "c0=20.0", "--set", "name=test"])
    assert cfg.relax and not cfg.reload
    assert cfg.restart_step == 42
    assert cfg.param("c0", 10.0) == 20.0
    assert cfg.param("name", "x") == "test"
    assert cfg.param("missing", 7) == 7


def test_parameter_file(tmp_path):
    p = tmp_path / "params.json"
    p.write_text(json.dumps({"dx": 0.05, "end_time": 5.0}))
    cfg = RunConfig.from_cli(["--parameter_file", str(p)])
    assert cfg.param("dx", 0.1) == 0.05
    assert cfg.param("end_time", 1.0) == 5.0


def test_save_load_roundtrip(tmp_path):
    cfg = RunConfig(relax=True, restart_step=7, parameters={"a": 1})
    path = str(tmp_path / "cfg.json")
    cfg.save(path)
    back = RunConfig.load(path)
    assert back.relax and back.restart_step == 7 and back.parameters == {"a": 1}
