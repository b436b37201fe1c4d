"""Chaos campaign drivers: composed fault schedules against the port's
supervised runs, each scenario with a declared contract.

Counterparts of the JAX package's ``scripts/chaos.py``,
``scripts/chaos_serve.py`` and ``scripts/chaos_fleet.py``, runnable as

    python -m pumiumtally_tpu_torch.chaos.campaign [--only NAME] [--list]
    python -m pumiumtally_tpu_torch.chaos.serve    [--only NAME] [--list]
    python -m pumiumtally_tpu_torch.chaos.fleet    [--only NAMES] [--list]

with the scripts' scenario names, ``--moves``/``--jobs``, contracts and
exit codes (0 only when every scenario met its contract), and
``--device {cuda,cpu}`` (the card by default; without one they raise).
"""
