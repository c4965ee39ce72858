"""The plain reference: its automaton against a sample-by-sample walk,
the whole reference against the program (its plain versions, on the CPU)
within each cell's limit, and the control (the reference in bfloat16)
above each limit, at a size a test run holds."""

import json

import numpy as np
import pytest
import torch

from conftest import cut_to_test_size
from portbench import check, control, spec
from portbench.reference import automaton

REST, ATTACK, HOLD, RELEASE = range(4)


def walk(over, att, rel):
    """The automaton one sample at a time, from its definition."""
    x_max, y_max, ratio = len(att), len(rel), att[-1]
    mode, x, y, skip = REST, 0, 0, False
    g = np.ones(len(over))
    for i, o in enumerate(over):
        if skip:
            skip = False
            continue
        if mode == REST:
            if o:
                mode, x = (HOLD if x_max == 1 else ATTACK), 1
            continue
        if mode == ATTACK:
            g[i] = att[x]
            x += 1
            if x >= x_max:
                mode = HOLD
            continue
        if o:
            g[i], mode, y = ratio, HOLD, 0
            continue
        g[i] = rel[y]
        mode, y = RELEASE, y + 1
        if y >= y_max:
            mode, y, skip = REST, 0, True
    return g


@pytest.mark.parametrize("x_max, y_max, p", [(1, 1, 0.3), (1, 5, 0.2),
                                             (4, 3, 0.1), (7, 20, 0.05),
                                             (3, 9, 0.6), (50, 30, 0.01)])
def test_automaton_equals_the_walk(x_max, y_max, p):
    rng = np.random.default_rng(x_max * 100 + y_max)
    att = np.linspace(1.0, 0.6, x_max)
    rel = np.linspace(0.6, 1.0, y_max)
    for _ in range(5):
        over = rng.random(3000) < p
        got = automaton.gains(torch.from_numpy(over), att, rel,
                              torch.float64).numpy()
        np.testing.assert_array_equal(got, walk(over, att, rel))


def cells():
    return [w["name"] for w in spec.load_benchmark()["workloads"]]


def small_cell(checkout, name):
    return spec.cell(name, root=checkout)


@pytest.mark.parametrize("name", cells())
def test_the_control_fails_every_cell_at_a_small_size(checkout, name):
    cell = small_cell(checkout, name)
    limit = cell.limits[check.REL_ERR]["limit"]
    for seed in (1, 2, 3):
        r = control.reading(cell, seed, "cpu", steps=200)
        assert r[check.REL_ERR] > 3 * limit, r


@pytest.mark.parametrize("name", cells())
def test_the_reference_agrees_with_the_programs_plain_versions(checkout,
                                                               name):
    from portbench import port, signals
    cell = small_cell(checkout, name)
    config, traffic = cell.config, cell.traffic
    B = int(traffic["block_size"])
    chain, cfg = port.chain(config, B, "cpu")
    n = int(config["length_s"] * config["sample_rate"])
    x = signals.make(traffic["signal"], config["channels"], n,
                     config["sample_rate"], 11, "cpu")
    got = port.pt.render(chain, x, cfg)[:, :n]
    pad = torch.nn.functional.pad(x, (0, -(-n // B) * B - n))
    want = check.reference(config, pad, B)[:, :n]
    assert check.rel_err(got, want) < cell.limits[check.REL_ERR]["limit"]


def configs():
    return sorted({w["config"] for w in spec.load_benchmark()["workloads"]})


@pytest.mark.parametrize("name", configs())
def test_every_configuration_has_a_smaller_test_size(name):
    with open(spec.config_path(name)) as f:
        config = json.load(f)
    small = cut_to_test_size(config)
    assert set(config["test_size"]) == {"channels", "length_s"}
    assert 1 <= small["channels"] <= config["channels"]
    assert 0 < small["length_s"] <= config["length_s"]
