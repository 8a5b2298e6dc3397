"""The traffic generator: the same seed gives the same inputs, and every
seed the same sizes in another order."""
import json
from pathlib import Path

import numpy as np

from hbench.traffic.generator import RolloutTraffic, TrainTraffic, levels

HB = Path(__file__).resolve().parents[1]
BIG = 2 ** 31 + 12345


def mix(name):
    return json.loads((HB / "traffic" / f"{name}.json").read_text())


def test_levels_are_quantiles():
    assert levels({"dist": "uniform", "lo": 0, "hi": 4096}, 4).tolist() == [512, 1536, 2560, 3584]
    lg = levels({"dist": "loguniform", "lo": 256, "hi": 5120}, 32)
    assert lg[0] >= 256 and lg[-1] < 5120 and np.all(np.diff(lg) > 0)


def test_rollout_deterministic_and_same_sizes():
    p = mix("grpo_rollout_long")
    a, b, c = (RolloutTraffic(p, s, 151936) for s in (BIG, BIG, BIG + 1))
    ia, ib, ic = a.initial(), b.initial(), c.initial()
    assert json.dumps(ia) == json.dumps(ib)
    assert [s["prompt"] for s in ia] != [s["prompt"] for s in ic]
    assert sorted(len(s["response"]) for s in ia) == sorted(len(s["response"]) for s in ic)
    assert sorted(len(s["prompt"]) for s in ia) == sorted(len(s["prompt"]) for s in ic)
    assert len(ia) == 384 and all(len(s["prompt"]) <= 1024 for s in ia)
    # GRPO groups of 16 share one prompt
    groups = {}
    for s in ia:
        groups.setdefault(s["prompt_id"], set()).add(tuple(s["prompt"]))
    assert len(groups) == 24 and all(len(v) == 1 for v in groups.values())
    na = [a.next_request() for _ in range(40)]
    nb = [b.next_request() for _ in range(40)]
    assert json.dumps(na) == json.dumps(nb)
    assert all(min(r["prompt"]) >= 3 for r in na)


def test_train_deterministic_and_same_sizes():
    p = mix("grpo_train")
    a, b, c = (TrainTraffic(p, s, 151936) for s in (BIG, BIG, 7))
    ba, bb, bc = a.batch(3), b.batch(3), c.batch(3)
    assert json.dumps(ba) == json.dumps(bb)
    lens = lambda bt: sorted(len(t["prompt_tokens"]) + len(t["response_tokens"]) for t in bt)
    assert lens(ba) == lens(bc) == lens(a.batch(4))
    assert len(ba) == 32 and max(lens(ba)) <= 6144
    assert sum(lens(ba)) == a.tokens(3)
    for g in range(2):
        r = [t["reward"] for t in ba if t["prompt_id"] == 300 + g]
        assert 0.0 in r and 1.0 in r
    assert all(max(t["behav_logprobs"]) <= 0.0 for t in ba)
    lag = [a.max_staleness + 3 - t["behavior_version"] for t in ba]
    assert min(lag) >= 0 and max(lag) <= a.max_staleness
