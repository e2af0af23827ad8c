"""Registry of adjudicated-loser knobs (counterpart of
isogs_slam_tpu/slam/experimental.py).

Every knob here was measured in the JAX package and lost (slower, or
harmful to quality on sequences) under its documented conditions. The
verdicts below are that package's records, from its own runs (NOTES.md
there is the source): the qualities carry over as far as the algorithms
are the same, the speed verdicts were taken on other hardware and say
nothing about this package on a GPU. Every knob listed runs here; an
enabled one gets its warning and then does what it says.
"""
from __future__ import annotations

# (section, key) -> (trigger, verdict): trigger(value) says "the
# experimental path is enabled", verdict is the recorded result.
LOSERS = {
    ("mapping", "lazy_adam"): (
        lambda v: bool(v),
        "loses at tile_subsample > 1 (ATE 6.88 cm lazy vs 2.35 cm dense): "
        "visit-count Adam underfits exactly where the subset path is "
        "underfit. Keep dense Adam."),
    ("mapping", "vmap_bins"): (
        lambda v: bool(v),
        "slower than serial slot binnings on the exact path."),
    ("tracking", "early_stop_patience"): (
        lambda v: int(v or 0) > 0,
        "loses at full resolution (3 seeds: ATE median 0.308 vs 0.135 cm, "
        "PSNR -2.5 dB) while saving 7% of the iterations."),
    ("tracking", "fan_rounds"): (
        lambda v: int(v or 0) > 0,
        "harmful on sequences (ATE 3.64 vs ~2.2 cm): descending the biased "
        "tracking loss absorbs map error into the pose. Unit-scene polish "
        "only."),
    ("tracking", "gn_iters"): (
        lambda v: int(v or 0) > 0,
        "dead for sequence tracking (ATE 25.75 cm, super-linear drift). "
        "Unit-scene pose polish only."),
    ("raster", "tile_cull"): (
        lambda v: bool(v),
        "slower than the plain modes on isotropic post-densify scenes; "
        "wins only on anisotropic flake scenes."),
    ("raster", "tight_rect"): (
        lambda v: bool(v),
        "slower on the bench scene, intersection demand did not shrink; "
        "wins only on flakes / post-opacity-reset regimes."),
}


def warn_experimental(config: dict) -> list[str]:
    """Print one loud line per enabled adjudicated-loser knob; returns
    the warning strings (for tests)."""
    warnings = []
    for (section, key), (trigger, verdict) in LOSERS.items():
        val = config.get(section, {}).get(key)
        if val is not None and trigger(val):
            msg = (f"[experimental] {section}.{key}={val!r} is an "
                   f"ADJUDICATED LOSER (the JAX package's record): "
                   f"{verdict}")
            print(msg, flush=True)
            warnings.append(msg)
    return warnings
