"""Offscreen visualization: meshes, mode shapes, waveforms, spectrograms -> image files
(counterpart of mesheditor_tpu/viz.py).

The reference observes through ImGui/ImPlot panels and a deterministic headless render
corpus (SURVEY.md §5.5, README.md:184-197); this headless framework renders matplotlib
figures instead: the same artifacts (scene views, mode-shape maps, waveform/spectrum
plots) as files a corpus test can diff. Host numpy and matplotlib only, no device.
matplotlib is imported when a function is called, so the module imports without it; a
call without it raises an ImportError that names the function.
"""

from __future__ import annotations

import numpy as np


def _agg(caller: str):
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(f"viz.{caller} needs matplotlib, which is not installed") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_mesh_png(path, positions, triangles, vertex_values=None, elev=25, azim=-60,
                    title=""):
    """Shaded triangle mesh, optionally colored per vertex (e.g. a mode shape)."""
    plt = _agg("render_mesh_png")
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    positions = np.asarray(positions, dtype=np.float64)
    tris = np.asarray(triangles, dtype=np.int64)
    fig = plt.figure(figsize=(6, 6), dpi=110)
    ax = fig.add_subplot(projection="3d")
    polys = positions[tris]
    if vertex_values is not None:
        vals = np.asarray(vertex_values, dtype=np.float64)[tris].mean(axis=1)
        vals = (vals - vals.min()) / max(vals.max() - vals.min(), 1e-30)
        import matplotlib.cm as cm

        colors = cm.viridis(vals)
    else:
        colors = "#7aa6c2"
    pc = Poly3DCollection(polys, facecolors=colors, edgecolors="k", linewidths=0.1)
    ax.add_collection3d(pc)
    lo, hi = positions.min(axis=0), positions.max(axis=0)
    c = (lo + hi) / 2
    r = float((hi - lo).max()) / 2 or 1.0
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_modes_png(path, modes, title="modal spectrum"):
    """Stem plot of mode frequencies vs T60s (the reference's mode chart)."""
    plt = _agg("plot_modes_png")
    fig, ax = plt.subplots(figsize=(7, 3.2), dpi=110)
    freqs = np.asarray(modes.freqs)
    t60s = np.asarray(modes.t60s) * 1e3
    ax.stem(freqs, t60s, basefmt=" ")
    ax.set_xlabel("frequency (Hz)")
    ax.set_ylabel("T60 (ms)")
    ax.set_xscale("log")
    ax.set_title(f"{title}: {freqs.size} modes, f1 {freqs[0]:.0f} Hz" if freqs.size else title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_waveform_png(path, audio, sample_rate=48_000.0, title="waveform + spectrogram"):
    """Waveform over a log-spectrogram (the reference's ImPlot audio panels)."""
    plt = _agg("plot_waveform_png")
    audio = np.asarray(audio, dtype=np.float64).reshape(-1)
    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(8, 5), dpi=110, sharex=True)
    t = np.arange(audio.size) / sample_rate
    ax0.plot(t, audio, linewidth=0.4)
    ax0.set_ylabel("amplitude")
    ax0.set_title(title)
    nfft = 2048
    hop = 512
    n_frames = max((audio.size - nfft) // hop + 1, 1)
    frames = np.stack([audio[i * hop : i * hop + nfft] * np.hanning(nfft)
                       for i in range(n_frames)])
    spec = np.abs(np.fft.rfft(frames, axis=1)).T
    db = 20 * np.log10(np.maximum(spec, 1e-9))
    ax1.imshow(db, origin="lower", aspect="auto",
               extent=[0, n_frames * hop / sample_rate, 0, sample_rate / 2 / 1000],
               cmap="magma", vmin=db.max() - 90, vmax=db.max())
    ax1.set_ylabel("kHz")
    ax1.set_xlabel("time (s)")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
