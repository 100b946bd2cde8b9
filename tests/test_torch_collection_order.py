"""The root conftest.py's collection order: `spread_heavy` deals the cases of
HEAVY_CASES through the order so that pytest-xdist's `--dist load` spreads
them over its workers. All cases are pure Python."""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import types

import pytest

import xdist_replay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# `import conftest` would be ambiguous with tests/conftest.py.
_spec = importlib.util.spec_from_file_location(
    "root_conftest", os.path.join(REPO, "conftest.py"))
root_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(root_conftest)

LISTED = [nodeid for nodeid, _ in root_conftest.HEAVY_CASES]
SECONDS = dict(root_conftest.HEAVY_CASES)
FIRST_CHUNK = 38  # xdist's first run of cases a worker: 927 cases, 6 workers


def _light(n):
    return [f"tests/test_light_{i // 50:02d}.py::test_case[{i}]" for i in range(n)]


def _bunched(n=927):
    """Today's shape of the suite: the listed cases next to each other,
    near the front of `n` cases."""
    light = _light(n - len(LISTED))
    return light[:2] + LISTED + light[2:]


def _spread(ids):
    return [it.nodeid for it in root_conftest.spread_heavy(
        [types.SimpleNamespace(nodeid=i) for i in ids])]


def _most_in_window(order, window):
    at = [i for i, nodeid in enumerate(order) if nodeid in SECONDS]
    return max(sum(a <= p < a + window for p in at) for a in at)


def _assert_spread(order, most):
    at = [i for i, nodeid in enumerate(order) if nodeid in SECONDS]
    assert _most_in_window(order, FIRST_CHUNK) <= most
    assert max(at) < 0.9 * len(order)


def test_result_is_a_permutation():
    ids = _bunched()
    out = _spread(ids)
    assert len(out) == len(ids)
    assert sorted(out) == sorted(ids)
    assert out != ids


def test_unlisted_cases_keep_their_relative_order():
    ids = _bunched()
    assert [i for i in _spread(ids) if i not in SECONDS] == \
        [i for i in ids if i not in SECONDS]


def test_listed_cases_not_collected_are_ignored():
    light = _light(200)
    picked = [LISTED[5], LISTED[1], LISTED[20]]
    ids = light[:10] + picked + light[10:]
    out = _spread(ids)
    assert sorted(out) == sorted(ids)
    assert [i for i in out if i in SECONDS] == \
        sorted(picked, key=lambda i: -SECONDS[i])
    assert _spread(light) == light
    assert _spread([]) == []


def test_listed_cases_spread_at_todays_size():
    order = _spread(_bunched(927))
    assert _most_in_window(_bunched(927), FIRST_CHUNK) == FIRST_CHUNK
    _assert_spread(order, most=2)


def test_order_is_the_same_under_any_hash_seed():
    code = (
        "import importlib.util, json, sys, types\n"
        "spec = importlib.util.spec_from_file_location('c', sys.argv[1])\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "ids = json.load(sys.stdin)\n"
        "items = [types.SimpleNamespace(nodeid=i) for i in ids]\n"
        "print(json.dumps([it.nodeid for it in mod.spread_heavy(items)]))\n"
    )
    ids = _bunched()
    runs = [subprocess.Popen(
        [sys.executable, "-c", code, os.path.join(REPO, "conftest.py")],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONHASHSEED=seed)) for seed in ("0", "4242")]
    orders = [json.loads(run.communicate(json.dumps(ids), timeout=60)[0])
              for run in runs]
    assert [run.returncode for run in runs] == [0, 0]
    assert orders[0] == orders[1] == _spread(ids)


FUNCTIONS = list(dict.fromkeys(nodeid.split("[")[0] for nodeid in LISTED))


@pytest.mark.parametrize(
    "function", FUNCTIONS,
    ids=[f.replace(".py::", ".") for f in FUNCTIONS])
def test_listed_case_names_a_test_function(function):
    path, name = function.split("::")
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    assert name in [node.name for node in tree.body
                    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))]


def test_list_is_heaviest_first_without_repeats():
    seconds = [s for _, s in root_conftest.HEAVY_CASES]
    assert seconds == sorted(seconds, reverse=True)
    assert min(seconds) >= 20
    assert len(LISTED) == len(SECONDS)


def test_session_order_spreads_the_listed_cases(request):
    order = [item.nodeid for item in request.session.items]
    if not all(nodeid in order for nodeid in LISTED):
        pytest.skip("run with the whole suite: not every listed case was collected")
    # 2 at today's size; more only once the list holds more than
    # 0.8 * len(order) / 19 cases.
    most = -(-FIRST_CHUNK * len(LISTED) * 5 // (4 * len(order)))
    _assert_spread(order, most)


def test_replay_runs_every_case_once():
    order = _light(100)
    seconds = {nodeid: 1.0 for nodeid in order}
    ran = xdist_replay.replay(order, seconds, workers=4)
    assert sorted(nodeid for r in ran for nodeid in r) == sorted(order)
    assert [len(r) for r in ran] == [25, 25, 25, 25]


def test_replay_predicts_the_spread_order_faster():
    seconds = dict(SECONDS, **{nodeid: 0.5 for nodeid in _light(927)})
    walls = []
    for order in (_bunched(), _spread(_bunched())):
        ran = xdist_replay.replay(order, seconds)
        walls.append(max(sum(seconds[n] for n in r) for r in ran))
    bunched, spread = walls
    ideal = sum(seconds[n] for n in _bunched()) / 6
    assert spread < 1.1 * ideal < bunched
