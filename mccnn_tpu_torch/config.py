"""Experiment configuration registry.

Mirrors the reference CLI surface (`main.lua:10-297`): positional
``dataset in {kitti, kitti2015, mb}`` and ``arch in {fast, slow, ad,
census}``, with per-(dataset, arch) conditional defaults for every
hyperparameter. Flag names are kept identical so the reference's
hyperparameter-search harnesses drive this CLI unchanged.

``print_args`` maps internal names to paper notation exactly as
`main.lua:299-322` does.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional

DATASETS = ("kitti", "kitti2015", "mb")
ARCHES = ("fast", "slow", "ad", "census")
ACTIONS = ("train_tr", "train_all", "test_te", "test_all", "submit", "time", "predict")


@dataclass
class Config:
    dataset: str = "kitti"
    arch: str = "fast"

    # generic flags (main.lua:16-32)
    gpu: int = 1  # 1-based CUDA device index (cutorch.setDevice parity)
    seed: int = 42
    debug: bool = False
    a: str = "train_tr"
    net_fname: str = ""
    make_cache: bool = False
    use_cache: bool = False
    print_args: bool = False
    sm_terminate: str = ""  # cnn|cbca1|sgm|cbca2|occlusion|mismatch|subpixel_enchancement|median
    sm_skip: str = ""  # cbca|sgm|occlusion|subpixel_enchancement|median|bilateral
    tiny: bool = False
    subset: float = 1.0

    # predict-mode inputs (main.lua:30-32)
    left: str = ""
    right: str = ""
    disp_max: Optional[int] = None

    # data augmentation (main.lua:34-66)
    hflip: int = 0
    vflip: int = 0
    rotate: float = 7.0
    hscale: float = 0.9
    scale: float = 1.0
    trans: float = 0.0
    hshear: float = 0.1
    brightness: float = 0.7
    contrast: float = 1.3
    d_vtrans: float = 0.0
    d_rotate: float = 0.0
    d_hscale: float = 1.0
    d_hshear: float = 0.0
    d_brightness: float = 0.3
    d_contrast: float = 1.0

    # middlebury-specific (main.lua:116-118, 267-269)
    rect: str = "imperfect"
    color: str = "gray"
    ds: int = 2001
    d_exp: float = 0.2
    d_light: float = 0.2

    # dataset merge (main.lua:72, 208)
    at: int = 0

    # network dims (main.lua:74-78 slow, 212-214 fast)
    l1: int = 4
    fm: int = 64
    ks: int = 3
    l2: int = 4
    nh2: int = 384

    # training (main.lua:79-84)
    lr: float = 0.002
    bs: int = 128
    mom: float = 0.9
    true1: float = 1.0
    false1: float = 4.0
    false2: float = 10.0

    # fast-arch hinge loss (main.lua:209-210)
    m: float = 0.2
    pow: int = 1

    # stereo-method hyperparameters (main.lua:86-293)
    L1: int = 0
    tau1: float = 0.0
    cbca_i1: int = 0
    cbca_i2: int = 0
    pi1: float = 4.0
    pi2: float = 55.72
    sgm_i: int = 1
    sgm_q1: float = 3.0
    sgm_q2: float = 2.5
    alpha1: float = 1.5
    tau_so: float = 0.02
    blur_sigma: float = 7.74
    blur_t: float = 5.0

    # extensions with no reference analog (pipeline.py: the dtype
    # contract of the JAX package's check_vol_dtype)
    dtype: str = "float32"  # compute dtype for the matching network
    vol_dtype: str = "float32"  # cost-volume storage dtype (HWD lane)
    backend: str = ""  # "cpu" runs the plain versions on the host; "" = CUDA
    data_dir: str = ""  # override dataset directory
    checkpoint_every: int = 0  # mid-train checkpointing (0 = reference behavior)
    resume: str = ""  # resume training from a checkpoint directory
    num_devices: int = 0  # 0 = all visible devices (data-parallel training)
    # shape bucketing for variable-size (Middlebury) eval: images are
    # edge-padded up to multiples of bucket_hw and disp_max up to
    # multiples of bucket_d (padded disparities are NaN-masked, the
    # output is cropped back). -1 = auto (64/64 on mb, off elsewhere);
    # 0/1 = off (train/evaluate.py bucketed_predict).
    bucket_hw: int = -1
    bucket_d: int = -1

    def validate(self) -> "Config":
        assert self.dataset in DATASETS, self.dataset
        assert self.arch in ARCHES, self.arch
        assert self.a in ACTIONS, self.a
        assert self.vol_dtype in ("float32", "float16", "bfloat16"), \
            self.vol_dtype
        return self

    @property
    def err_at(self) -> int:
        # main.lua:400 (kitti) / main.lua:453 (mb)
        return 3 if self.dataset in ("kitti", "kitti2015") else 1

    @property
    def n_input_plane(self) -> int:
        # main.lua:399, main.lua:448-452
        if self.dataset == "mb" and self.color == "rgb":
            return 3
        return 1

    @property
    def ws(self) -> int:
        """Patch window size of the conv tower: (ks-1)*l1 + 1 (main.lua:382-391)."""
        return (self.ks - 1) * self.l1 + 1


# ---------------------------------------------------------------------------
# Per-(dataset, arch) default tables, transcribed from main.lua:34-295.
# ---------------------------------------------------------------------------

_AUG_KITTI = dict(
    hflip=0, vflip=0, rotate=7.0, hscale=0.9, scale=1.0, trans=0.0, hshear=0.1,
    brightness=0.7, contrast=1.3, d_vtrans=0.0, d_rotate=0.0, d_hscale=1.0,
    d_hshear=0.0, d_brightness=0.3, d_contrast=1.0,
)
_AUG_MB = dict(
    hflip=0, vflip=0, rotate=28.0, hscale=0.8, scale=0.8, trans=0.0, hshear=0.1,
    brightness=1.3, contrast=1.1, d_vtrans=1.0, d_rotate=3.0, d_hscale=0.9,
    d_hshear=0.3, d_brightness=0.7, d_contrast=1.1,
)

_SLOW_NET_KITTI = dict(at=0, l1=4, fm=112, ks=3, l2=4, nh2=384, lr=0.003, bs=128,
                       mom=0.9, true1=1.0, false1=4.0, false2=10.0)
_SLOW_NET_MB = dict(ds=2001, d_exp=0.2, d_light=0.2, l1=5, fm=112, ks=3, l2=3,
                    nh2=384, lr=0.003, bs=128, mom=0.9, true1=0.5, false1=1.5,
                    false2=18.0)
_FAST_NET_KITTI = dict(at=0, m=0.2, pow=1, l1=4, fm=64, ks=3, lr=0.002, bs=128,
                       mom=0.9, true1=1.0, false1=4.0, false2=10.0)
_FAST_NET_MB = dict(m=0.2, pow=1, ds=2001, d_exp=0.2, d_light=0.2, l1=5, fm=64,
                    ks=3, lr=0.002, bs=128, mom=0.9, true1=0.5, false1=1.5,
                    false2=6.0)

_SM = {
    # main.lua:86-99
    ("kitti", "slow"): dict(L1=5, cbca_i1=2, cbca_i2=0, tau1=0.13, pi1=1.32,
                            pi2=24.25, sgm_i=1, sgm_q1=3.0, sgm_q2=2.0,
                            alpha1=2.0, tau_so=0.08, blur_sigma=5.99, blur_t=6.0),
    # main.lua:100-114
    ("kitti2015", "slow"): dict(L1=5, cbca_i1=2, cbca_i2=4, tau1=0.03, pi1=2.3,
                                pi2=24.25, sgm_i=1, sgm_q1=3.0, sgm_q2=2.0,
                                alpha1=1.75, tau_so=0.08, blur_sigma=5.99,
                                blur_t=5.0),
    # main.lua:132-144
    ("mb", "slow"): dict(L1=14, tau1=0.02, cbca_i1=2, cbca_i2=16, pi1=1.3,
                         pi2=13.9, sgm_i=1, sgm_q1=4.5, sgm_q2=2.0, alpha1=2.75,
                         tau_so=0.13, blur_sigma=1.67, blur_t=2.0),
    # main.lua:146-160
    ("kitti", "census"): dict(L1=0, cbca_i1=4, cbca_i2=8, tau1=0.01, pi1=4.0,
                              pi2=128.0, sgm_i=1, sgm_q1=3.0, sgm_q2=3.5,
                              alpha1=1.25, tau_so=1.0, blur_sigma=7.74, blur_t=6.0),
    # main.lua:161-175
    ("mb", "census"): dict(L1=5, cbca_i1=8, cbca_i2=8, tau1=0.22, pi1=4.0,
                           pi2=32.0, sgm_i=1, sgm_q1=4.0, sgm_q2=3.0, alpha1=1.5,
                           tau_so=1.0, blur_sigma=2.78, blur_t=3.0),
    # main.lua:176-190
    ("kitti", "ad"): dict(L1=3, cbca_i1=0, cbca_i2=4, tau1=0.03, pi1=0.76,
                          pi2=13.93, sgm_i=1, sgm_q1=3.5, sgm_q2=2.0, alpha1=2.5,
                          tau_so=0.01, blur_sigma=7.74, blur_t=6.0),
    # main.lua:191-205
    ("mb", "ad"): dict(L1=5, cbca_i1=0, cbca_i2=4, tau1=0.36, pi1=0.4, pi2=8.0,
                       sgm_i=1, sgm_q1=3.0, sgm_q2=4.0, alpha1=2.5, tau_so=0.08,
                       blur_sigma=7.74, blur_t=1.0),
    # main.lua:222-234
    ("kitti", "fast"): dict(L1=0, cbca_i1=0, cbca_i2=0, tau1=0.0, pi1=4.0,
                            pi2=55.72, sgm_i=1, sgm_q1=3.0, sgm_q2=2.5,
                            alpha1=1.5, tau_so=0.02, blur_sigma=7.74, blur_t=5.0),
    # main.lua:250-262
    ("kitti2015", "fast"): dict(L1=0, cbca_i1=0, cbca_i2=0, tau1=0.0, pi1=2.3,
                                pi2=18.38, sgm_i=1, sgm_q1=3.0, sgm_q2=2.0,
                                alpha1=1.25, tau_so=0.08, blur_sigma=4.64,
                                blur_t=5.0),
    # main.lua:281-293
    ("mb", "fast"): dict(L1=0, tau1=0.0, cbca_i1=0, cbca_i2=0, pi1=2.3, pi2=24.3,
                         sgm_i=1, sgm_q1=4.0, sgm_q2=2.0, alpha1=1.5, tau_so=0.08,
                         blur_sigma=6.0, blur_t=2.0),
}
# kitti2015 shares kitti's tables for census/ad (main.lua:147,177)
_SM[("kitti2015", "census")] = _SM[("kitti", "census")]
_SM[("kitti2015", "ad")] = _SM[("kitti", "ad")]


def defaults_for(dataset: str, arch: str) -> dict:
    """Return the conditional-default dict for a (dataset, arch) pair."""
    d: dict = {}
    if dataset in ("kitti", "kitti2015"):
        d.update(_AUG_KITTI)
    else:
        d.update(_AUG_MB)
    if arch == "slow":
        d.update(_SLOW_NET_KITTI if dataset != "mb" else _SLOW_NET_MB)
    elif arch == "fast":
        if dataset == "kitti":
            d.update(_FAST_NET_KITTI)
        elif dataset == "kitti2015":
            d.update(dict(_FAST_NET_KITTI))
        else:
            d.update(_FAST_NET_MB)
    d.update(_SM[(dataset, arch)])
    return d


def make_config(dataset: str, arch: str, **overrides) -> Config:
    d = defaults_for(dataset, arch)
    d.update(overrides)
    fields = {f.name for f in dataclasses.fields(Config)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return Config(dataset=dataset, arch=arch, **d).validate()


def _add_flags(parser: argparse.ArgumentParser, defaults: dict) -> None:
    for f in dataclasses.fields(Config):
        if f.name in ("dataset", "arch"):
            continue
        default = defaults.get(f.name, f.default)
        if f.type in ("bool", bool) or isinstance(default, bool):
            parser.add_argument(f"-{f.name}", action="store_true", default=default)
        elif f.name == "disp_max":
            parser.add_argument("-disp_max", type=int, default=None)
        else:
            typ = type(default) if default is not None else str
            parser.add_argument(f"-{f.name}", type=typ, default=default)


def parse_args(argv: list[str]) -> tuple[Config, list[str]]:
    """Parse ``dataset arch -flag value ...`` exactly like main.lua's CLI.

    Returns the config plus the raw flag tail (main.lua:344-347).
    """
    if len(argv) < 2:
        raise SystemExit("usage: python -m mccnn_tpu_torch <dataset> <arch> [-a action] [flags]")
    dataset, arch = argv[0], argv[1]
    if dataset not in DATASETS:
        raise SystemExit(f"dataset must be one of {DATASETS}, got {dataset!r}")
    if arch not in ARCHES:
        raise SystemExit(f"arch must be one of {ARCHES}, got {arch!r}")
    tail = argv[2:]
    parser = argparse.ArgumentParser(prog=f"python -m mccnn_tpu_torch {dataset} {arch}", allow_abbrev=False)
    _add_flags(parser, defaults_for(dataset, arch))
    ns = parser.parse_args(tail)
    cfg = Config(dataset=dataset, arch=arch, **vars(ns)).validate()
    return cfg, tail


def cmd_str(cfg: Config, tail: list[str]) -> str:
    """Artifact-name string: dataset_arch_<raw flags> (main.lua:344-347)."""
    return "_".join([cfg.dataset, cfg.arch] + [str(t) for t in tail])


def print_args(cfg: Config) -> None:
    """Paper-notation dump (main.lua:299-322)."""
    rows = [
        ((cfg.ks - 1) * cfg.l1 + 1, "arch_patch_size"),
        (cfg.l1, "arch1_num_layers"),
        (cfg.fm, "arch1_num_feature_maps"),
        (cfg.ks, "arch1_kernel_size"),
        (cfg.l2, "arch2_num_layers"),
        (cfg.nh2, "arch2_num_units_2"),
        (cfg.false1, "dataset_neg_low"),
        (cfg.false2, "dataset_neg_high"),
        (cfg.true1, "dataset_pos_low"),
        (cfg.tau1, "cbca_intensity"),
        (cfg.L1, "cbca_distance"),
        (cfg.cbca_i1, "cbca_num_iterations_1"),
        (cfg.cbca_i2, "cbca_num_iterations_2"),
        (cfg.pi1, "sgm_P1"),
        (cfg.pi1 * cfg.pi2, "sgm_P2"),
        (cfg.sgm_q1, "sgm_Q1"),
        (cfg.sgm_q1 * cfg.sgm_q2, "sgm_Q2"),
        (cfg.alpha1, "sgm_V"),
        (cfg.tau_so, "sgm_intensity"),
        (cfg.blur_sigma, "blur_sigma"),
        (cfg.blur_t, "blur_threshold"),
    ]
    for val, name in rows:
        print(val, name)
