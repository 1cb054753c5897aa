"""The one traffic generator: a configuration's query library and a traffic
mix's episodes, plants and groups, all drawn from the run's seed.

Audio is seeded noise at the configuration's rate, made on the device with
a ``torch.Generator`` in a few large calls, quantized there to the staging
wire and copied to the host once: the program is handed host samples, as
a decoder hands them. Each plant adds one query, at a seeded gain in
``plants["gain"]``, onto the episode's noise, as a jingle is mixed into a
programme; plants lie ``gap_secs`` apart (more than the matcher's
distance), so every plant is a match the configuration must report.

Episodes (``traffic["episodes"]``, kind ``"pool"``): ``count`` episodes
of ``secs`` each, cycled.

The cycle is grouped by the frozen copy of ``sweep_archive``'s rule
(:func:`group_rule`); the run seed picks the group the window starts with,
so every seed does the same work in another order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import rng, stream_seed

WIRE_BYTES = {"float32": 4, "int16": 2, "mulaw8": 1}
I16_SCALE = 65535.0  # the wire's PCM scale: int16 value / 65535


@dataclasses.dataclass
class Traffic:
    sr: int
    wire: str
    queries: list  # f32 host arrays, one a query
    episodes: list  # host arrays in the wire dtype
    plants: list  # per episode: [(query, first sample)]
    groups: list  # episode indices a group
    start: int  # the group the window starts with

    def group(self, k: int) -> list:
        """The k-th group of the window, cycling from :attr:`start`."""
        return self.groups[(self.start + k) % len(self.groups)]

    def seconds(self, e: int) -> float:
        return len(self.episodes[e]) / self.sr


def group_rule(n_bytes, max_rows: int, max_bytes: int) -> list:
    """Groups of episode indices, in order: the frozen copy of
    ``sweep_archive``'s rule. At most ``max_rows`` a group, and a group is
    closed before its padded buffer (rows × its widest row's wire bytes)
    would pass ``max_bytes``, or once it reaches it."""
    groups, group, row_max = [], [], 0
    for i, nb in enumerate(n_bytes):
        new_max = max(row_max, nb)
        if group and (len(group) + 1) * new_max > max_bytes:
            groups.append(group)
            group, new_max = [], nb
        group.append(i)
        row_max = new_max
        if len(group) == max_rows or len(group) * row_max >= max_bytes:
            groups.append(group)
            group, row_max = [], 0
    if group:
        groups.append(group)
    return groups


def query_lengths(cfg: dict) -> list[int]:
    q = cfg["queries"]
    return [int(round((q["secs_base"] + q["secs_step"] * (i % q["secs_cycle"]))
                      * cfg["sample_rate"])) for i in range(q["count"])]


def _generator(device, seed: int, stream: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def _to_wire(x: torch.Tensor, wire: str) -> np.ndarray:
    if wire == "float32":
        return x.cpu().numpy()
    if wire == "int16":
        q = (x * I16_SCALE).round_().clamp_(-32768, 32767)
        return q.to(torch.int16).cpu().numpy()
    raise ValueError(f"the generator has no {wire!r} wire")


def _plant_positions(r: np.random.Generator, n: int, plants: dict,
                     sr: int, longest: int) -> list[int]:
    lo, hi = plants["first_secs"]
    p = r.uniform(lo, hi) * sr
    out = []
    while True:
        at = int(p + r.uniform(0, plants["jitter_secs"]) * sr)
        if at + longest > n:
            return out
        out.append(at)
        p += plants["gap_secs"] * sr


def make(cfg: dict, mix: dict, seed: int, device) -> Traffic:
    """The traffic of one run: ``cfg`` a configuration, ``mix`` a traffic
    mix, ``device`` where the audio is drawn."""
    sr = cfg["sample_rate"]
    wire = cfg["match"]["transfer_dtype"]
    qc = cfg["queries"]
    lengths_q = query_lengths(cfg)
    longest = max(lengths_q)
    g = _generator(device, seed, "queries")
    flat = torch.randn(sum(lengths_q), generator=g, device=device)
    flat = (flat * qc["std"]).clamp_(-qc["clip"], qc["clip"])
    q_dev = list(torch.split(flat, lengths_q))
    queries = [q.cpu().numpy() for q in q_dev]

    ep = mix["episodes"]
    r_plants = rng(seed, "plants")
    noise = mix["noise_std"]
    g = _generator(device, seed, "episodes")
    if ep["kind"] == "pool":
        n = int(ep["secs"] * sr)
        audio = torch.randn((ep["count"], n), generator=g, device=device)
        audio.mul_(noise)
        plants = []
        for e in range(ep["count"]):
            got = []
            for at in _plant_positions(r_plants, n, mix["plants"], sr,
                                       longest):
                q = int(r_plants.integers(len(queries)))
                gain = r_plants.uniform(*mix["plants"]["gain"])
                audio[e, at : at + lengths_q[q]] += gain * q_dev[q]
                got.append((q, at))
            plants.append(got)
        rows = _to_wire(audio, wire)
        del audio
        episodes = list(rows)
    else:
        raise ValueError(f"unknown episode kind {ep['kind']!r}")

    gr = mix["grouping"]
    groups = group_rule([len(e) * WIRE_BYTES[wire] for e in episodes],
                        gr["max_rows"], gr["max_bytes"])
    start = int(rng(seed, "start").integers(len(groups)))
    return Traffic(sr, wire, queries, episodes, plants, groups, start)
