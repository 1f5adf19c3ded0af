"""The comparison that decides `correct`: the program's outputs against the
plain reference's, scenario by scenario.

A state is walked by field name (dataclasses, dicts), so the program's
containers and the reference's own, which have the same fields, meet
leaf by leaf without either importing the other. Each layer of a tick is
a set of leaves; a scenario's error in a layer is the largest absolute
difference over its leaves (a non-finite value counts as infinite), and
the number compared is a quantile of that error over the sampled
scenarios."""

import dataclasses
import math

import numpy as np
import torch

# the quantile of the per-scenario errors that is compared: the closed
# loop's contacts make and break, and in about one scenario in a hundred a
# float32 rounding flips a discrete choice (a contact, a line-search step)
# that float64 makes the other way; the 90th percentile stays clear of
# those and still sees a fault in a tenth of the scenarios
QUANTILE = 0.9


def leaves(obj, prefix=""):
    """{dotted field path: tensor} of a tree of dataclasses and dicts."""
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(leaves(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(leaves(v, f"{prefix}{k}."))
        return out
    if torch.is_tensor(obj):
        return {prefix[:-1]: obj}
    return {}


def fill(template, values, prefix=""):
    """`template` (a tree of dataclasses and dicts) with every tensor leaf
    replaced by `values[path]`, cast to the template leaf's dtype and
    device."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: fill(getattr(template, f.name), values,
                         f"{prefix}{f.name}.")
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: fill(v, values, f"{prefix}{k}.")
                for k, v in template.items()}
    if torch.is_tensor(template):
        return values[prefix[:-1]].to(template.device, template.dtype)
    return template


def sample(seed, batch, n):
    """`n` scenario indices of `batch`, drawn from `seed`, sorted (all of
    them when n >= batch)."""
    if n >= batch:
        return torch.arange(batch)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5EED]))
    return torch.as_tensor(np.sort(rng.choice(batch, n, replace=False)))


def rows(tree_leaves, idx, batch):
    """Copies of the sampled scenarios' rows of every batched leaf (leading
    axis `batch`); unbatched leaves are copied whole."""
    out = {}
    for k, v in tree_leaves.items():
        if v.dim() and v.shape[0] == batch:
            out[k] = v[idx.to(v.device)].clone()
        else:
            out[k] = v.clone()
    return out


def scenario_error(prog, ref, names):
    """(S,) float64: per scenario, the largest |prog - ref| over the leaves
    whose path starts with one of `names`; inf where either side is not
    finite."""
    errs = []
    for k, a in prog.items():
        if not any(k == n or k.startswith(n + ".") for n in names):
            continue
        if a.dtype == torch.bool:
            continue
        a = a.double()
        b = ref[k].to(a.device).double()
        d = (a - b).abs()
        d = torch.where(torch.isfinite(a) & torch.isfinite(b), d,
                        torch.full_like(d, math.inf))
        errs.append(d.reshape(d.shape[0], -1).amax(-1))
    if not errs:
        raise KeyError(f"no leaf under {names}")
    return torch.stack(errs, -1).amax(-1).cpu()


def summary(err):
    """The quantile compared, and the distribution beside it."""
    e = err.double()
    q = torch.tensor([0.5, QUANTILE, 0.99], dtype=torch.float64)
    p50, pq, p99 = torch.quantile(e, q).tolist() if torch.isfinite(
        e).all() else (math.inf,) * 3
    return dict(value=pq, p50=p50, p99=p99, max=float(e.max()))


def layer_errors(ticks, layers):
    """{tick.layer: (S,) per-scenario error} over `ticks` ((tag, program
    leaves, reference leaves)) and `layers` ({layer: leaf paths})."""
    return {f"{tag}.{layer}": scenario_error(prog, ref, names)
            for tag, prog, ref in ticks for layer, names in layers.items()}


def judged(limits, errors):
    """The numbers compared: [(name, the quantile of its per-scenario
    error, its limit)] for `errors` ({name: (S,) errors}), and each
    number's distribution (`summary`) by name."""
    dists = {name: summary(e) for name, e in errors.items()}
    return ([(name, dists[name]["value"], limits[name]) for name in errors],
            dists)


def final_quality(sim):
    """Upright share (trunk over 0.15 m), mean and least height, mean x
    and forward speed of the batch at the window's end
    (`parallel/distributed.reduce_metrics`' arithmetic), and the scenarios
    whose trunk state is not finite."""
    z = sim.pos[:, 2].double()
    finite = (torch.isfinite(sim.pos).all(-1)
              & torch.isfinite(sim.vel).all(-1))
    return {"upright_frac": float((z > 0.15).double().mean()),
            "mean_height": float(z.mean()), "min_height": float(z.min()),
            "mean_dx": float(sim.pos[:, 0].double().mean()),
            "mean_speed": float(sim.vel[:, 0].double().mean()),
            "nonfinite": int((~finite).sum())}


def tf32_side(side):
    """A driver's plain side (a namespace of functions) with every function
    run under TF32 matrix products: the check's control."""
    from types import SimpleNamespace

    from benchmark.tf32 import Tf32Products

    def under(fn):
        def wrapped(*args, **kwargs):
            with Tf32Products():
                return fn(*args, **kwargs)
        return wrapped
    return SimpleNamespace(**{k: under(v) if callable(v) else v
                              for k, v in vars(side).items()})


def require(config, fixed):
    """Refuse a configuration whose keys in `fixed` (the settings a cell
    module supports) ask for something else."""
    wrong = {k: config.get(k) for k, v in fixed.items() if config.get(k) != v}
    if wrong:
        raise ValueError(f"configuration {config.get('name')!r}: the "
                         f"cell supports {fixed}, the file asks {wrong}")


class SampledCell:
    """What the drivers' cells share: the configuration (refused unless its
    keys in `fixed` are the settings it supports), the traffic, the seed, the
    device, the batch, and the scenarios the check samples from the seed."""
    fixed = {}
    check_note = ("a sample drawn from the seed; the first tick of set-up "
                  "from the reference's own start, the window's last tick "
                  "from the program's state before it; float64; per "
                  "scenario the largest absolute error of a layer, the "
                  f"{QUANTILE:g} quantile compared")

    def __init__(self, config, traffic, seed, device, control=False):
        require(config, self.fixed)
        self.cfg, self.trf = config, traffic
        self.seed, self.device, self.control = seed, device, control
        self.batch = traffic["batch"]
        self.idx = sample(seed, self.batch, traffic["check_scenarios"])
