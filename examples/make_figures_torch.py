"""Render the port's key outputs as figures: true/initial/inverted models,
FWI gradient, wavefield snapshots, shot gathers and an RTM image; the
counterpart of `examples/make_figures.py`, with its own copies of the
plot functions.

Run:  python examples/make_figures_torch.py [outdir] [--exp /path/to/exp]
          [--device cuda|cpu]

Without --exp it runs a quick self-contained twin experiment; with --exp it
plots the artifacts of a previous `python -m sep2023_tpu_torch invert` run.
The forwards, the snapshots (`cuda_engine.snapshots_cuda_plan`), `rtm` and
the inversion run the CUDA kernels on `--device cuda` and their plain
PyTorch versions on `--device cpu`.  NZ, NX, NT and RTM_NT size the
figures' problems (the original script's sizes).  Where
matplotlib is not installed each figure is written as a raster PNG of its
panels side by side, without axes or titles (`_raster`).
"""
import argparse
import glob
import os
import struct
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sep2023_tpu_torch import (cli, heads, models, optimize,  # noqa: E402
                               parallel)
from sep2023_tpu_torch.ops import cuda_engine  # noqa: E402

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:
    plt = None

NZ, NX, NT, RTM_NT = 64, 128, 501, 800


def _raster(path, panels):
    """Write panels [(array (h, w), symmetric)] side by side as one RGB
    PNG, 4 px of white between them: gray from min to max, or blue-white-red
    over +-max |a| where symmetric.  Returns path."""
    h = max(a.shape[0] for a, _ in panels)
    tiles = []
    for a, symmetric in panels:
        a = np.asarray(a, np.float64)
        if symmetric:
            v = np.abs(a).max() + 1e-30
            t = np.clip(a / v, -1.0, 1.0)[..., None]
            rgb = np.where(t < 0, [1.0, 1.0, 1.0] + t * [1.0, 1.0, 0.0],
                           [1.0, 1.0, 1.0] - t * [0.0, 1.0, 1.0])
        else:
            lo, hi = a.min(), a.max()
            rgb = np.repeat(((a - lo) / (hi - lo + 1e-30))[..., None], 3, -1)
        tile = np.ones((h, a.shape[1] + 4, 3))
        tile[:a.shape[0], :a.shape[1]] = rgb
        tiles.append(tile)
    img = (np.concatenate(tiles, axis=1) * 255).round().astype(np.uint8)
    raw = b"".join(b"\x00" + row.tobytes() for row in img)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1],
                                              img.shape[0], 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw))
                 + chunk(b"IEND", b""))
    print("wrote", path, "(raster: matplotlib is not installed)")
    return path


def plot_models(vp_true, vp_init, vp_inv, grad, outdir, dx, dz):
    path = os.path.join(outdir, "fwi_models.png")
    if plt is None:
        return _raster(path, [(vp_true, False), (vp_init, False),
                              (vp_inv, False), (grad, True)])
    fig, axes = plt.subplots(2, 2, figsize=(12, 7), constrained_layout=True)
    ext = [0, vp_true.shape[1] * dx / 1000, vp_true.shape[0] * dz / 1000, 0]
    vmin, vmax = vp_true.min(), vp_true.max()
    for ax, (arr, title) in zip(axes.flat, [
            (vp_true, "true Vp"), (vp_init, "initial Vp"),
            (vp_inv, "inverted Vp"), (grad, "first-iteration gradient")]):
        if title.endswith("gradient"):
            v = np.abs(arr).max()
            im = ax.imshow(arr, extent=ext, cmap="seismic", vmin=-v, vmax=v)
        else:
            im = ax.imshow(arr, extent=ext, cmap="viridis",
                           vmin=vmin, vmax=vmax)
        ax.set_title(title)
        ax.set_xlabel("x (km)")
        ax.set_ylabel("z (km)")
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print("wrote", path)
    return path


def plot_gather(data, dt, outdir):
    path = os.path.join(outdir, "shot_gather.png")
    if plt is None:
        return _raster(path, [(d.T, True) for d in data])
    fig, axes = plt.subplots(1, 4, figsize=(16, 5), constrained_layout=True)
    names = ("pr", "vx", "vz", "ett (DAS)")
    for c, (ax, name) in enumerate(zip(axes, names)):
        d = data[c]
        v = np.abs(d).max() * 0.2 + 1e-30
        ax.imshow(d.T, aspect="auto", cmap="gray", vmin=-v, vmax=v,
                  extent=[0, d.shape[0], d.shape[1] * dt, 0])
        ax.set_title(name)
        ax.set_xlabel("receiver")
        ax.set_ylabel("t (s)")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print("wrote", path)
    return path


def plot_snaps(snaps, outdir):
    n = snaps.shape[0]
    picks = np.linspace(1, n - 1, 6).astype(int)
    path = os.path.join(outdir, "wavefield.png")
    if plt is None:
        return _raster(path, [(snaps[k], True) for k in picks])
    fig, axes = plt.subplots(2, 3, figsize=(14, 7), constrained_layout=True)
    v = np.abs(snaps[picks]).max() * 0.25
    for ax, k in zip(axes.flat, picks):
        ax.imshow(snaps[k], cmap="seismic", vmin=-v, vmax=v)
        ax.set_title(f"snapshot {k}")
        ax.axis("off")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print("wrote", path)
    return path


def plot_rtm(npz_path, outdir):
    with np.load(npz_path) as z:
        vp_t, img, z_refl = z["vp_true"], z["image_muted"], int(z["z_reflector"])
    npml = (img.shape[0] - vp_t.shape[0]) // 2
    img = img[npml:npml + vp_t.shape[0], npml:npml + vp_t.shape[1]]
    path = os.path.join(outdir, "rtm.png")
    if plt is None:
        return _raster(path, [(vp_t, False), (img, True)])
    fig, axes = plt.subplots(1, 2, figsize=(10, 3.2), constrained_layout=True)
    axes[0].imshow(vp_t, aspect="auto", cmap="viridis")
    axes[0].set_title("true vp (reflector at z=%d)" % z_refl)
    lim = np.percentile(np.abs(img), 99.5) + 1e-30
    axes[1].imshow(img, aspect="auto", cmap="gray", vmin=-lim, vmax=lim)
    axes[1].set_title("RTM image (muted)")
    for ax in axes:
        ax.set_xlabel("x")
        ax.set_ylabel("z")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print("wrote", path)
    return path


def plot_overthrust(npz_path, outdir):
    """Overthrust spline-fiber DAS panel (examples/overthrust_das_torch.py
    artifact): model + cable channels, initial and inverted Vp."""
    z = np.load(npz_path)
    vp_t, vp_i, vp_o = z["vp_true"], z["vp_init"], z["vp_out"]
    rec_z, rec_x = z["rec_z"], z["rec_x"]
    path = os.path.join(outdir, "overthrust_das.png")
    if plt is None:
        return _raster(path, [(vp_t, False), (vp_i, False), (vp_o, False)])
    fig, axes = plt.subplots(1, 3, figsize=(15, 4), constrained_layout=True)
    vmin, vmax = vp_t.min(), vp_t.max()
    for ax, (arr, title) in zip(axes, [
            (vp_t, "true Vp + spline DAS cable"),
            (vp_i, "initial Vp (smoothed)"),
            (vp_o, "inverted Vp (L-BFGS-B)")]):
        im = ax.imshow(arr, cmap="viridis", vmin=vmin, vmax=vmax)
        ax.set_title(title)
        ax.set_xlabel("x (cells)")
        ax.set_ylabel("z (cells)")
    axes[0].plot(rec_x, rec_z, "r.-", ms=4, lw=1, label="fiber channels")
    axes[0].legend(loc="lower right")
    fig.colorbar(im, ax=axes, shrink=0.8)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print("wrote", path)
    return path


def plot_marmousi(npz_path, outdir):
    """Marmousi-scale twin experiment (examples/marmousi_scale_torch.py
    artifact): true / initial / inverted Vp, the recovered perturbation and
    the per-iteration in-anomaly model error, the recovery metric."""
    z = np.load(npz_path)
    vp_t, vp_i, vp_o = z["vp_true"], z["vp_init"], z["vp_out"]
    nit = (len(z["anom_err_per_iter"]) - 1 if "anom_err_per_iter" in z
           else "?")
    path = os.path.join(outdir, "marmousi_scale.png")
    if plt is None:
        return _raster(path, [(vp_t, False), (vp_i, False), (vp_o, False),
                              (vp_o - vp_i, True)])
    fig = plt.figure(figsize=(14, 11), constrained_layout=True)
    gs = fig.add_gridspec(4, 2)
    vmin, vmax = vp_t.min(), vp_t.max()
    for r, (arr, title) in enumerate([
            (vp_t, "true Vp: overthrust + 3 Gaussian anomalies "
                   "(750x2000, 7.5x20 km)"),
            (vp_i, "initial Vp (smoothed background, no anomalies)"),
            (vp_o, f"inverted Vp ({nit} L-BFGS-B iters)")]):
        ax = fig.add_subplot(gs[r, :])
        im = ax.imshow(arr, cmap="viridis", vmin=vmin, vmax=vmax,
                       aspect="auto")
        ax.set_title(title)
        ax.set_ylabel("z (cells)")
        fig.colorbar(im, ax=ax, shrink=0.9)
    dv = np.abs(vp_t - vp_i).max()
    ax = fig.add_subplot(gs[3, 0])
    im = ax.imshow(vp_o - vp_i, cmap="seismic", vmin=-dv, vmax=dv,
                   aspect="auto")
    ax.set_title("recovered perturbation (inverted - initial)")
    ax.set_xlabel("x (cells)")
    ax.set_ylabel("z (cells)")
    fig.colorbar(im, ax=ax, shrink=0.9)
    if "anom_err_per_iter" in z:
        ax = fig.add_subplot(gs[3, 1])
        err = z["anom_err_per_iter"]
        ax.plot(np.arange(len(err)), err, "o-", color="tab:red")
        ax.set_title("in-anomaly mean |vp error| per iteration")
        ax.set_xlabel("L-BFGS-B iteration")
        ax.set_ylabel("m/s")
        ax.grid(alpha=0.3)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print("wrote", path)
    return path


def main(argv=None):
    """Returns what it made: the figures' paths, and without --exp the
    inversion's first and last misfit and its evaluations."""
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", nargs="?", default="/tmp/figs")
    ap.add_argument("--exp", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    device = torch.device(args.device)
    nz, nx = NZ, NX
    cfg, survey, geoms, stf = cli.benchmark_problem(
        nz=nz, nx=nx, nt=NT, npml=24, device=device)
    stf = stf.contiguous()
    vp_t, vs_t, rho_t = models.anomaly_vp_vs_rho(nz, nx)
    vp_i = models.smooth(vp_t, 8.0)
    t = lambda a: torch.as_tensor(np.asarray(a)).to(device, torch.float32)

    head = heads.vp_vs_rho(cfg.grid, dict(vp=vp_i, vs=vs_t, rho=rho_t),
                           mask=heads.default_mask(cfg.grid, 0))
    apply = lambda vp: tuple(a.contiguous() for a in head.apply(
        {"vp": vp, "vs": t(vs_t), "rho": t(rho_t)}))
    model_t = apply(t(vp_t))
    fwd = parallel.make_forward(cfg, survey, use_kernels=True, device=device)
    obs = fwd(*model_t, stf)
    figures = [plot_gather(obs[len(obs) // 2].cpu().numpy(), cfg.dt,
                           args.outdir)]

    # wavefield movie of the middle shot (its source, the first wavelet)
    plan, _ = parallel._cuda_plan(cfg, survey)
    mid = survey.n_shots // 2
    n = cfg.npml
    _, snaps = cuda_engine.snapshots_cuda_plan(
        plan, *model_t, stf[:1], [survey.src_z[mid] + n],
        [survey.src_x[mid] + n], [survey.src_rxz[mid]], save_every=25)
    figures.append(plot_snaps(snaps[:, 0, 0].cpu().numpy(), args.outdir))

    # RTM migration panel (the rtm CLI's twin experiment)
    rtm_npz = os.path.join(args.outdir, "rtm_image.npz")
    cli.main(["rtm", "--nz", str(nz), "--nx", str(nx), "--nt",
              str(RTM_NT), "--npml", "24", "--out", rtm_npz,
              "--device", args.device])
    figures.append(plot_rtm(rtm_npz, args.outdir))

    if args.exp:
        snaps_files = sorted(glob.glob(os.path.join(args.exp, "Results",
                                                    "model_*.npz")))
        grads_files = sorted(glob.glob(os.path.join(args.exp, "Results",
                                                    "grad_*.npz")))
        with np.load(snaps_files[-1]) as z:
            vp_inv = z["vp"]
        grad = None
        if grads_files:
            with np.load(grads_files[0]) as z:
                grad = z["vp"]
        # rebuild true/init at the experiment's grid size
        ez, ex = vp_inv.shape
        vp_te, _, _ = models.anomaly_vp_vs_rho(ez, ex)
        vp_ie = models.smooth(vp_te, 8.0)
        figures.append(plot_models(
            vp_te, vp_ie, vp_inv,
            grad if grad is not None else np.zeros_like(vp_inv),
            args.outdir, cfg.dx, cfg.dz))
        return {"figures": figures}

    # quick inline inversion for the figure
    w = torch.ones(survey.n_shots, device=device)
    loss_d = parallel.make_cuda_misfit(cfg, survey,
                                       channels=("ett", "vx", "vz"))

    def loss(p, stf_, obs_):
        return loss_d(*apply(p["vp"]), stf_, obs_, w)

    obj = optimize.ScipyObjective(loss, {"vp": vp_i}, aux=(stf, obs),
                                  device=device)
    f0 = obj.fun(obj.x0)                       # evaluate at x0 first so
    grad0 = obj.unpack(obj.jac(obj.x0))["vp"]  # this is iteration 0's
    res = optimize.lbfgsb(obj, maxiter=15)
    vp_inv = obj.unpack(res.x)["vp"].cpu().numpy()
    figures.append(plot_models(vp_t, vp_i, vp_inv, grad0.cpu().numpy(),
                               args.outdir, cfg.dx, cfg.dz))
    print(f"misfit {f0:.3e} -> {res.fun:.3e}")
    return {"figures": figures, "misfit0": f0, "misfit1": float(res.fun),
            "n_evals": obj.n_evals}


if __name__ == "__main__":
    main()
