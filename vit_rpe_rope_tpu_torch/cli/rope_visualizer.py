"""RoPE frequency visualizer: the reference tool's flags and outputs, plus
--device. Axial-vs-mixed FFT spectra per input pattern, theta sensitivity
sweeps, and trained-model comparison (reads .npz and torch .pth
checkpoints). Defaults are the reference's: dim 64, grid 8, theta_axial 100,
theta_mixed 10, 4 heads, and the custom purple→blue→green→yellow→orange
colormap.

  python -m vit_rpe_rope_tpu_torch.cli.rope_visualizer --compare_thetas

The rotation tables are computed on the CUDA device; --device cpu runs on
the CPU. Untrained rope-mixed frequencies are drawn from a torch.Generator
seeded with 0 (viz/rope_freq.mixed_freqs), so they differ from the JAX
package's tool by design. `figures(args)` computes what main() draws, and
needs no matplotlib; main() draws it with matplotlib on the Agg backend.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

from vit_rpe_rope_tpu_torch.utils.device import resolve_device
from vit_rpe_rope_tpu_torch.viz import introspect, rope_freq


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="RoPE Frequency Visualization Tool")

    # Configuration for visualization
    parser.add_argument("--grid_size", type=int, default=8,
                        help="Size of grid for visualization (default: 8)")
    parser.add_argument("--dim", type=int, default=64,
                        help="Dimension for RoPE encoding (default: 64)")
    parser.add_argument("--theta_axial", type=float, default=100.0,
                        help="Theta parameter for RoPE-Axial (default: 100.0)")
    parser.add_argument("--theta_mixed", type=float, default=10.0,
                        help="Theta parameter for RoPE-Mixed (default: 10.0)")
    parser.add_argument("--num_heads", type=int, default=4,
                        help="Number of attention heads for RoPE-Mixed "
                             "(default: 4)")

    # Input position pattern configurations
    parser.add_argument("--patterns", type=str, nargs="+",
                        default=["single", "double", "corner", "diagonal"],
                        help="Test position patterns (options: single, double, "
                             "corner, diagonal, custom)")
    parser.add_argument("--custom_pattern", type=str, default=None,
                        help='Custom pattern as comma-separated list of '
                             'coordinates "row1,col1,row2,col2,..."')

    # Advanced visualization options
    parser.add_argument("--head_indices", type=int, nargs="+", default=[0],
                        help="Head indices to visualize for RoPE-Mixed "
                             "(default: [0])")
    parser.add_argument("--compare_thetas", action="store_true",
                        help="Compare different theta values for sensitivity "
                             "analysis")
    parser.add_argument("--theta_values", type=float, nargs="+",
                        default=[10.0, 100.0, 1000.0],
                        help="Theta values to compare (default: [10.0, 100.0, "
                             "1000.0])")

    # Model loading parameters
    parser.add_argument("--load_model", action="store_true",
                        help="Load a trained model to visualize its learned "
                             "frequencies")
    parser.add_argument("--model_path", type=str, default=None,
                        help="Path to the trained model checkpoint")
    parser.add_argument("--model_config", type=str, default="rope-mixed",
                        choices=["rope-axial", "rope-mixed"],
                        help="Positional encoding method of the model")

    # Comparative model analysis
    parser.add_argument("--compare_models", action="store_true",
                        help="Compare two models (Axial and Mixed) side by side")
    parser.add_argument("--axial_model_path", type=str, default=None,
                        help="Path to the RoPE-Axial model checkpoint")
    parser.add_argument("--mixed_model_path", type=str, default=None,
                        help="Path to the RoPE-Mixed model checkpoint")

    # Output configuration
    parser.add_argument("--output_dir", type=str, default="visualizations",
                        help="Directory to save visualizations")
    parser.add_argument("--dpi", type=int, default=300,
                        help="DPI for saved figures (default: 300)")
    parser.add_argument("--cmap", type=str, default="custom",
                        choices=["custom", "viridis", "plasma", "inferno",
                                 "magma", "cividis"],
                        help="Colormap for frequency visualization")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs on the "
                             "CPU)")
    return parser.parse_args(argv)


def _pyplot():
    """matplotlib.pyplot on the Agg backend, imported at the first figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def create_colormap(name):
    """The reference's 5-color map."""
    plt = _pyplot()
    if name == "custom":
        from matplotlib.colors import LinearSegmentedColormap

        colors = [(0.5, 0, 0.5), (0, 0, 0.5), (0, 1, 0), (1, 1, 0), (1, 0.5, 0)]
        return LinearSegmentedColormap.from_list("custom_cmap", colors, N=256)
    return plt.get_cmap(name)


def _save(fig, args, name):
    plt = _pyplot()
    os.makedirs(args.output_dir, exist_ok=True)
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    path = os.path.join(args.output_dir, f"rope_freq_{name}_{ts}.png")
    fig.savefig(path, dpi=args.dpi, bbox_inches="tight")
    plt.close(fig)
    print(f"Saved visualization to {path}")
    return path


def _custom_coords(args):
    if args.custom_pattern:
        return args.custom_pattern.split(",")
    return None


def _pattern_figures(args, axial=None, mixed=None, tag=""):
    """Per pattern: the input grid, the axial (log spectrum, reconstruction)
    and each selected head's mixed one; default tables where a model gave
    none."""
    g = args.grid_size
    if axial is None:
        axial = rope_freq.axial_freqs(args.dim, args.theta_axial, g,
                                      device=args.device)
    if mixed is None:
        mixed = rope_freq.mixed_freqs(args.dim, args.num_heads,
                                      args.theta_mixed, g, device=args.device)
    out = []
    for pattern in args.patterns:
        pos = rope_freq.create_input_positions(pattern, g, _custom_coords(args))
        heads = [(hidx, *rope_freq.apply_rope_and_fft(pos, *mixed,
                                                      head_idx=hidx))
                 for hidx in args.head_indices]
        out.append(("pattern", (pattern, pos,
                                rope_freq.apply_rope_and_fft(pos, *axial),
                                heads, tag)))
    return out


def draw_pattern(pattern, pos, axial_fft, heads, tag, args):
    """One pattern's row of [input | axial FFT | axial recon | mixed FFT
    (per head) | mixed recon]."""
    plt = _pyplot()
    cmap = create_colormap(args.cmap)
    ncols = 3 + 2 * len(heads)
    fig, axes = plt.subplots(1, ncols, figsize=(3 * ncols, 3.2))
    axes[0].imshow(pos, cmap="gray")
    axes[0].set_title(f"input: {pattern}")
    mag, rec = axial_fft
    axes[1].imshow(mag, cmap=cmap)
    axes[1].set_title(f"axial FFT (θ={args.theta_axial:g})")
    axes[2].imshow(rec, cmap="gray")
    axes[2].set_title("axial recon")
    for i, (hidx, magm, recm) in enumerate(heads):
        axes[3 + 2 * i].imshow(magm, cmap=cmap)
        axes[3 + 2 * i].set_title(f"mixed FFT h{hidx}")
        axes[4 + 2 * i].imshow(recm, cmap="gray")
        axes[4 + 2 * i].set_title(f"mixed recon h{hidx}")
    for ax in axes:
        ax.set_xticks([])
        ax.set_yticks([])
    return _save(fig, args, f"{tag}{pattern}")


def _theta_figure(args):
    """Theta sensitivity sweep: the first pattern's axial and mixed log
    spectra at each theta."""
    g = args.grid_size
    pattern = args.patterns[0] if args.patterns else "single"
    pos = rope_freq.create_input_positions(pattern, g, _custom_coords(args))
    rows = []
    for theta in args.theta_values:
        mag_a, _ = rope_freq.apply_rope_and_fft(
            pos, *rope_freq.axial_freqs(args.dim, theta, g,
                                        device=args.device))
        mag_m, _ = rope_freq.apply_rope_and_fft(
            pos, *rope_freq.mixed_freqs(args.dim, args.num_heads, theta, g,
                                        device=args.device))
        rows.append((theta, mag_a, mag_m))
    return ("thetas", (pattern, rows))


def draw_thetas(pattern, rows, args):
    plt = _pyplot()
    cmap = create_colormap(args.cmap)
    fig, axes = plt.subplots(2, len(rows), figsize=(3 * len(rows), 6.4),
                             squeeze=False)
    for j, (theta, mag_a, mag_m) in enumerate(rows):
        axes[0, j].imshow(mag_a, cmap=cmap)
        axes[0, j].set_title(f"axial θ={theta:g}")
        axes[1, j].imshow(mag_m, cmap=cmap)
        axes[1, j].set_title(f"mixed θ={theta:g}")
        for ax in (axes[0, j], axes[1, j]):
            ax.set_xticks([])
            ax.set_yticks([])
    fig.suptitle(f"Theta sensitivity ({pattern} pattern)")
    return _save(fig, args, "theta_comparison")


def _freqs_from_checkpoint(path, method, args):
    model = introspect.load_pe_model(path, method, args.grid_size,
                                     args.num_heads)
    g = min(model.grid_size, args.grid_size)
    if method == "rope-axial":
        return rope_freq.axial_freqs(model.head_dim, args.theta_axial, g,
                                     device=args.device)
    return rope_freq.mixed_freqs(
        model.head_dim, model.num_heads, args.theta_mixed, g,
        freqs_param=model.params["pos_embed.freqs"], device=args.device)


def _model_comparison(args):
    """Trained axial vs trained mixed. A checkpoint that fails to load is
    warned about and skipped (the comparison degrades to the surviving
    model), as the reference tool recovers instead of aborting."""
    axial = mixed = None
    for attr, method in (("axial_model_path", "rope-axial"),
                         ("mixed_model_path", "rope-mixed")):
        try:
            freqs = _freqs_from_checkpoint(getattr(args, attr), method, args)
            if method == "rope-axial":
                axial = freqs
            else:
                mixed = freqs
        except Exception as e:  # noqa: BLE001 — tool-level resilience
            print(f"Warning: could not load {getattr(args, attr)} as "
                  f"'{method}': {e}")
            print(f"Skipping {method}.")
    if axial is None and mixed is None:
        raise SystemExit("Neither model could be loaded for comparison.")
    return _pattern_figures(args, axial=axial, mixed=mixed, tag="models_")


def figures(args):
    """What main() draws for args, computed on args.device: a list of
    (kind, data), kind "pattern" with data (pattern, pos, (axial log
    spectrum, reconstruction), [(head, mixed log spectrum,
    reconstruction)], tag) or "thetas" with data (pattern, [(theta, axial
    log spectrum, mixed log spectrum)])."""
    if args.compare_models and args.axial_model_path and args.mixed_model_path:
        return _model_comparison(args)
    if args.load_model and args.model_path:
        if args.model_config == "rope-axial":
            axial = _freqs_from_checkpoint(args.model_path, "rope-axial", args)
            return _pattern_figures(args, axial=axial, tag="trained_")
        mixed = _freqs_from_checkpoint(args.model_path, "rope-mixed", args)
        return _pattern_figures(args, mixed=mixed, tag="trained_")
    out = _pattern_figures(args)
    if args.compare_thetas:
        out.append(_theta_figure(args))
    return out


def main(argv=None):
    """Draws figures(args); returns the PNG paths written."""
    args = get_args(argv)
    args.device = resolve_device(args.device)
    draw = {"pattern": draw_pattern, "thetas": draw_thetas}
    return [draw[kind](*data, args=args) for kind, data in figures(args)]


if __name__ == "__main__":
    main()
