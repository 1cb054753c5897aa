"""The multi-device dry run of the port: every sharded path on a mesh, with
plants checked (the JAX package's ``dryrun_multichip``).

    python -m audio_matcher_tpu_torch.parallel.dryrun 8 --device cpu

On a mesh of n devices it scans episodes with one plant each, at
``(e % 5) · sr/2 + sr/4``, through the resident scan (``xla_packed``
correlations with the dense single-read peak reduction, kernel 7 on a CUDA
device), the legacy windows path (torch ops) and the spectrogram scanner
(torch ops). Every plant must be found within 1 sample (64 samples in
spectrogram mode); a miss raises.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models.matcher import MatchConfig
from ..models.spectrogram import SpectrogramConfig
from .mesh import Mesh, make_mesh
from .sweep import ShardedScanner, ShardedSpectrogramScanner

SR = 1000


def plant_at(e: int) -> int:
    """Episode ``e``'s plant: any data-axis width fits the 4 s episodes,
    off the exact chunk boundaries."""
    return (e % 5) * SR // 2 + SR // 4


def dryrun_multichip(devices, device="cpu") -> str:
    """Run the dry run on ``devices`` (a :class:`~.mesh.Mesh`, or a count
    for ``make_mesh(devices, device)``); returns the line it prints."""
    mesh = devices if isinstance(devices, Mesh) else make_mesh(devices, device)
    rng = np.random.default_rng(0)
    snippets = [
        (rng.standard_normal(SR // 2) * 0.2).astype(np.float32),
        (rng.standard_normal(SR // 4) * 0.2).astype(np.float32),
    ]
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, slab=2, block=256,
                      fft_impl="xla_packed", peaks_impl="pallas")
    scanner = ShardedScanner(snippets, SR, cfg, device=mesh)
    n_episodes = max(mesh.shape[0], 2)
    episodes = []
    for e in range(n_episodes):
        ep = (rng.standard_normal(SR * 4) * 0.05).astype(np.float32)
        ep[plant_at(e) : plant_at(e) + len(snippets[0])] = snippets[0]
        episodes.append(ep)

    def check(results, label, tol):
        for e, per_query in enumerate(results):
            got = [p.position for p in per_query[0]]
            if not any(abs(p - plant_at(e)) <= tol for p in got):
                raise AssertionError(
                    f"{label} episode {e}: expected a match near "
                    f"{plant_at(e)}, got {got}")

    check(scanner.scan_resident(episodes), "resident", 1)
    check(scanner.scan(episodes), "windows", 1)
    spec = ShardedSpectrogramScanner(
        [snippets[0]], SR,
        SpectrogramConfig(n_fft=128, hop=32, n_mels=16, distance_secs=2.0,
                          min_score=0.3),
        device=mesh,
    )
    check(spec.scan_resident(episodes), "spectrogram", 64)
    line = (f"dryrun_multichip OK: {mesh.describe()}, {n_episodes} episodes "
            f"x {len(snippets)} queries matched on both sharded pcm paths "
            f"(xla_packed + pallas peaks) and the sharded spectrogram path")
    print(line)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int, help="devices in the mesh")
    p.add_argument("--device", default="cpu",
                   help="their kind: cpu (shards of the CPU) or cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
