"""Run configuration: CLI flags and parameter overrides.

Counterpart of the reference's Boost.program_options CLI
(sph_system.cpp:106-196: --relax --reload --regression --state_recording
--restart_step --log_level) and ParameterizationIO's project-parameter
override file (io_system/parameterization.h:44-60).  A dataclass + JSON
file subsumes both (SURVEY.md §5 recommends exactly this).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from typing import Any, Dict


@dataclasses.dataclass
class RunConfig:
    """The standard run flags every case accepts."""

    relax: bool = False              # run particle relaxation preprocessing
    reload: bool = False             # start from reloaded (relaxed) particles
    regression: bool = False         # generate/extend regression databases
    state_recording: bool = True     # write VTP body states
    restart_step: int = 0            # resume from this restart snapshot
    log_level: int = 20              # logging level (logging.INFO)
    output_dir: str = "output"
    restart_dir: str = "restart"
    reload_dir: str = "reload"
    parameters: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_cli(cls, argv=None) -> "RunConfig":
        p = argparse.ArgumentParser(description="sphinxsys_jax case runner")
        p.add_argument("--relax", action="store_true")
        p.add_argument("--reload", action="store_true")
        p.add_argument("--regression", action="store_true")
        p.add_argument("--no-state-recording", dest="state_recording",
                       action="store_false")
        p.add_argument("--restart_step", type=int, default=0)
        p.add_argument("--log_level", type=int, default=20)
        p.add_argument("--output_dir", default="output")
        p.add_argument("--parameter_file", default=None,
                       help="JSON file of case-parameter overrides "
                            "(ParameterizationIO counterpart)")
        p.add_argument("--set", action="append", default=[], metavar="K=V",
                       help="inline parameter override (repeatable)")
        a = p.parse_args(argv)
        params: Dict[str, Any] = {}
        if a.parameter_file:
            with open(a.parameter_file) as f:
                params.update(json.load(f))
        for kv in a.set:
            k, v = kv.split("=", 1)
            try:
                params[k] = json.loads(v)
            except json.JSONDecodeError:
                params[k] = v
        cfg = cls(relax=a.relax, reload=a.reload, regression=a.regression,
                  state_recording=a.state_recording,
                  restart_step=a.restart_step, log_level=a.log_level,
                  output_dir=a.output_dir, parameters=params)
        cfg.setup_logging()
        return cfg

    def setup_logging(self):
        logging.basicConfig(
            level=self.log_level,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    def param(self, name: str, default):
        """Case-parameter lookup with override (ParameterizationIO
        semantics: the file value wins over the case default)."""
        return self.parameters.get(name, default)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "RunConfig":
        with open(path) as f:
            return cls(**json.load(f))
