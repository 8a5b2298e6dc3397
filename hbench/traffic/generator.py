"""The one traffic generator: it reads a mix's data file
(``hbench/traffic/<name>.json``) and makes that mix's inputs from a seed.

Every seed gets the same multiset of sizes (prompt lengths, answer
lengths, rollout progress), taken at fixed quantiles of the mix's
distributions, in an order drawn from the seed; token ids, rewards and
behaviour log-probabilities are drawn from the seed.  So two seeds ask
for the same amount of work with different contents.

Two kinds of mix:

* ``"rollout"``: ``RolloutTraffic`` fills every slot of an engine with a
  snapshot of a request part-way through its answer (``initial``) and
  hands out fresh GRPO groups for the closed loop (``next_request``).
* ``"train"``: ``TrainTraffic.batch(k)`` is step k's global batch of
  trajectories, as plain dicts.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

FIRST_TOKEN = 3          # ids 0, 1 and 2 are the tokenizer's pad, bos and eos


def levels(dist: Dict, n: int) -> np.ndarray:
    """n sizes at the quantiles (j + 0.5) / n of ``dist`` (uniform or
    log-uniform over [lo, hi)), as integers."""
    lo, hi = float(dist["lo"]), float(dist["hi"])
    q = (np.arange(n) + 0.5) / n
    if dist["dist"] == "uniform":
        x = lo + (hi - lo) * q
    elif dist["dist"] == "loguniform":
        x = lo * (hi / lo) ** q
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.floor(x).astype(np.int64)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one named stream of one seed (any whole number)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *stream])


def token_ids(r: np.random.Generator, n: int, vocab: int) -> List[int]:
    return r.integers(FIRST_TOKEN, vocab, size=int(n)).tolist()


class RolloutTraffic:
    """Requests for a rollout engine of ``n_slots`` slots.  rids count up
    from 0; a request of group g has prompt_id g."""

    def __init__(self, params: Dict, seed: int, vocab: int):
        self.p = params
        self.seed = int(seed)
        self.vocab = int(vocab)
        eng = params["engine"]
        self.n_slots = int(eng["n_slots"])
        self.group = int(params["group_size"])
        self.max_gen = int(eng["max_gen_len"])
        self.prompt_levels = levels(params["prompt_len"], int(params["prompt_len"]["levels"]))
        self._next_rid = 0
        self._group = -1
        self._left_in_group = 0
        self._prompt: List[int] = []
        # the progress of every request, by rid: tokens of its answer that
        # the engine did not sample (a snapshot's), 0 for a fresh request
        self.progress: Dict[int, int] = {}

    def _new_group(self) -> None:
        self._group += 1
        g = self._group
        order = rng(self.seed, 1, g // len(self.prompt_levels)).permutation(
            len(self.prompt_levels))
        n = int(self.prompt_levels[order[g % len(self.prompt_levels)]])
        self._prompt = token_ids(rng(self.seed, 2, g), n, self.vocab)
        self._left_in_group = self.group

    def _request(self) -> Dict:
        if self._left_in_group == 0:
            self._new_group()
        self._left_in_group -= 1
        rid = self._next_rid
        self._next_rid += 1
        return {"rid": rid, "prompt_id": self._group, "prompt": list(self._prompt),
                "answer": None}

    def initial(self) -> List[Dict]:
        """One ``preempt_slot``-shaped snapshot a slot: a request whose
        answer already holds ``progress`` tokens drawn from the seed (the
        progress levels are uniform over the mix's range, in an order
        drawn from the seed)."""
        prog = levels(self.p["progress"], self.n_slots)
        prog = np.minimum(prog, self.max_gen - 1)[rng(self.seed, 3).permutation(self.n_slots)]
        snaps = []
        for j in range(self.n_slots):
            req = self._request()
            n = int(prog[j])
            resp = token_ids(rng(self.seed, 4, req["rid"]), n, self.vocab)
            self.progress[req["rid"]] = n
            snaps.append({**req, "response": resp, "logprobs": [-math.log(self.vocab)] * n,
                          "versions": [0] * n, "behavior_version": 0, "submit_time": 0.0,
                          "turns": 0, "env_spans": []})
        return snaps

    def next_request(self) -> Dict:
        """The next fresh request of the closed loop."""
        req = self._request()
        self.progress[req["rid"]] = 0
        return req


class TrainTraffic:
    """Global batches of ``batch_size`` prompts x ``answers_per_prompt``
    answers.  Each batch has the same sequence lengths in an order drawn
    from (seed, step)."""

    def __init__(self, params: Dict, seed: int, vocab: int):
        self.p = params
        self.seed = int(seed)
        self.vocab = int(vocab)
        rl = params["rl"]
        self.n_prompts = int(rl["batch_size"])
        self.n_answers = int(rl["answers_per_prompt"])
        self.max_staleness = int(rl.get("max_staleness", 8))
        self.prompt_levels = levels(params["prompt_len"], self.n_prompts)
        self.answer_levels = levels(params["answer_len"], self.n_prompts * self.n_answers)
        if self.prompt_levels.max() + self.answer_levels.max() > rl["microbatch_token_budget"]:
            raise ValueError("a sequence of this mix would not fit one micro-batch")
        # the log-probability of a token under a uniform policy: behaviour
        # log-probs sit near what a random model gives, so the decoupled
        # objective's importance weight stays near 1 and unclipped
        self.behav_center = -math.log(self.vocab)

    def batch(self, step: int) -> List[Dict]:
        r = rng(self.seed, 5, step)
        version = self.max_staleness + step
        out = []
        for g in r.permutation(self.n_prompts):
            # prompt level g with every n_prompts-th answer level, so that
            # every batch holds the same sequence lengths
            alens = r.permutation(self.answer_levels[g::self.n_prompts])
            prompt = token_ids(r, self.prompt_levels[g], self.vocab)
            # rewards 0 or 1, both in every group
            n_right = int(r.integers(1, self.n_answers))
            rewards = r.permutation(np.arange(self.n_answers) < n_right).astype(np.float32)
            for a in range(self.n_answers):
                n = int(alens[a])
                lag = int(r.integers(0, self.max_staleness + 1))
                blp = np.minimum(self.behav_center
                                 + float(self.p["behav_logprob_std"]) * r.standard_normal(n),
                                 0.0)
                out.append({"rid": step * 1000 + len(out), "prompt_id": step * 100 + int(g),
                            "prompt_tokens": prompt, "response_tokens": token_ids(r, n, self.vocab),
                            "behav_logprobs": blp.astype(np.float32).tolist(),
                            "behavior_version": version - lag, "reward": float(rewards[a])})
        return out

    def tokens(self, step: int) -> int:
        """Tokens of step ``step``'s batch (the same for every step)."""
        return int(self.n_answers * self.prompt_levels.sum() + self.answer_levels.sum())
