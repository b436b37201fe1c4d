"""The port's chaos campaign drivers (``pumiumtally_tpu_torch/chaos``) on
the CPU.

* each driver's ``--list`` names exactly its JAX script's scenarios
  (scripts/chaos.py, chaos_serve.py, chaos_fleet.py), read from the
  script's source by AST without importing it;
* one in-process scenario of each driver meets its contract
  (``transient_storm``, ``storm``, ``retry_storm``), and so do the two
  subprocess scenarios (``kill_restart``, ``router_kill``: a few server
  processes each);
* a broken contract (a perturbed reference flux) makes each driver exit
  non-zero.
"""
from __future__ import annotations

import ast
import os

import numpy as np
import pytest

from pumiumtally_tpu_torch.chaos import campaign, fleet, serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = {"campaign": (campaign, "chaos.py"),
           "serve": (serve, "chaos_serve.py"),
           "fleet": (fleet, "chaos_fleet.py")}


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for var in ("PUMI_TPU_FAULTS", "PUMI_TPU_IO_PIPELINE", "PUMI_TPU_TRACE",
                "PUMI_TPU_PROM_PORT", "PUMI_TPU_FLEET_OBS"):
        monkeypatch.delenv(var, raising=False)


def _jax_scenarios(script: str) -> list[str]:
    tree = ast.parse(open(os.path.join(REPO, "scripts", script)).read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "SCENARIOS"
                        for t in node.targets)):
            value = node.value
            items = value.keys if isinstance(value, ast.Dict) else value.elts
            return [ast.literal_eval(k) for k in items]
    raise AssertionError(f"{script} has no SCENARIOS")


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_list_matches_jax_script(driver, capsys):
    module, script = DRIVERS[driver]
    assert module.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == _jax_scenarios(script)


@pytest.mark.parametrize("driver,scenario", [
    ("campaign", "transient_storm"),
    ("serve", "storm"),
    ("fleet", "retry_storm"),
    ("serve", "kill_restart"),
    ("fleet", "router_kill"),
])
def test_scenario_meets_its_contract(driver, scenario, capsys):
    module, _ = DRIVERS[driver]
    rc = module.main(["--only", scenario, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "PASS" in out.splitlines()[-1]


def _perturb(flux):
    out = np.array(flux, copy=True)
    out.reshape(-1)[np.argmax(np.abs(out))] *= 1.0 + 1e-6
    return out


def test_campaign_fails_on_a_broken_contract(monkeypatch, capsys):
    real = campaign.reference_flux
    monkeypatch.setattr(campaign, "reference_flux",
                        lambda *a: _perturb(real(*a)))
    rc = campaign.main(["--only", "transient_storm", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1 and "FAIL" in out and "1 FAILURES" in out


def test_serve_fails_on_a_broken_contract(monkeypatch, capsys):
    real = serve.fleet

    def fleet_with_bad_reference(mesh, cfg, n_jobs, **kw):
        out = real(mesh, cfg, n_jobs, **kw)
        if not kw:  # the fault-free reference
            jid = sorted(out["results"])[0]
            out["results"][jid] = _perturb(out["results"][jid])
        return out

    monkeypatch.setattr(serve, "fleet", fleet_with_bad_reference)
    rc = serve.main(["--only", "storm", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1 and "survivors_bitwise=False" in out


def test_fleet_fails_on_a_broken_contract(monkeypatch, capsys):
    real = fleet.reference_results

    def bad_reference(*args):
        ref = real(*args)
        jid = sorted(ref)[0]
        return dict(ref, **{jid: _perturb(ref[jid])})

    monkeypatch.setattr(fleet, "reference_results", bad_reference)
    rc = fleet.main(["--only", "retry_storm", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1 and "bitwise=False" in out


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_unknown_scenario_is_refused(driver, capsys):
    module, _ = DRIVERS[driver]
    assert module.main(["--only", "no_such_scenario", "--device",
                        "cpu"]) == 2
