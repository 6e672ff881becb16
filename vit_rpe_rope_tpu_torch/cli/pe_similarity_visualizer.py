"""PE similarity visualizer: the reference tool's flags and outputs, plus
--device. A per-position grid of heatmaps, a compact block-matrix heatmap,
an N-model side-by-side comparison, and checkpoint auto-discovery
(checkpoints/cifar10_{method}_best.* flips the tool into comparison mode).
Reads .npz checkpoints and reference torch .pth state dicts.

  python -m vit_rpe_rope_tpu_torch.cli.pe_similarity_visualizer \\
      --load_model --model_path checkpoints/cifar10_relative_best.npz \\
      --model_config relative

The PE tables are computed on the CUDA device; --device cpu runs on the
CPU. `figures(args)` computes what main() draws, and needs no matplotlib;
main() draws it with matplotlib on the Agg backend. Without a checkpoint the encodings are drawn at random from a
torch.Generator seeded with 0 (the JAX package's tool draws from
jax.random.PRNGKey(0), so the two tools' random-init figures differ).
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import numpy as np
import torch

from vit_rpe_rope_tpu_torch import pe as pe_registry
from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.utils.device import resolve_device
from vit_rpe_rope_tpu_torch.viz import introspect, similarity

METHODS_ALL = ["absolute", "relative", "polynomial", "rope-axial", "rope-mixed"]


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Positional Encoding Similarity Visualizer")

    # Visualization configuration
    parser.add_argument("--grid_size", type=int, default=14,
                        help="Size of grid for visualization (default: 14)")
    parser.add_argument("--dim", type=int, default=192,
                        help="Embedding dimension (default: 192)")
    parser.add_argument("--num_heads", type=int, default=6,
                        help="Number of attention heads (default: 6)")

    # Encoding method selection
    parser.add_argument("--methods", type=str, nargs="+", default=METHODS_ALL,
                        help="Positional encoding methods to visualize")

    # Polynomial RPE parameters
    parser.add_argument("--poly_degree", type=int, default=3,
                        help="Degree for polynomial RPE (default: 3)")
    parser.add_argument("--poly_shared_heads", type=bool, default=True,
                        help="Whether to share polynomial coefficients across "
                             "heads (default: True)")

    # RoPE configuration
    parser.add_argument("--rope_theta", type=float, default=100.0,
                        help="Theta parameter for RoPE variants (default: 100.0)")
    parser.add_argument("--rope_head_idx", type=int, default=0,
                        help="Head index to visualize for RoPE-Mixed (default: 0)")

    # Model loading parameters
    parser.add_argument("--load_model", action="store_true",
                        help="Load a trained model to visualize its learned "
                             "positional encodings")
    parser.add_argument("--model_path", type=str, default=None,
                        help="Path to the trained model checkpoint")
    parser.add_argument("--model_config", type=str, default="absolute",
                        choices=METHODS_ALL,
                        help="Positional encoding method of the model")

    # Model comparison settings
    parser.add_argument("--compare_models", action="store_true",
                        help="Compare multiple models side by side")
    parser.add_argument("--model_paths", type=str, nargs="+", default=None,
                        help="List of model paths to compare")
    parser.add_argument("--model_configs", type=str, nargs="+", default=None,
                        help="List of model configs corresponding to model_paths")
    parser.add_argument("--model_names", type=str, nargs="+", default=None,
                        help="Custom names for models in comparison (optional)")

    # Output configuration
    parser.add_argument("--output_dir", type=str, default="visualizations",
                        help="Directory to save visualizations")
    parser.add_argument("--dpi", type=int, default=300,
                        help="DPI for saved figures (default: 300)")
    parser.add_argument("--cmap", type=str, default="viridis",
                        choices=["viridis", "plasma", "inferno", "magma",
                                 "cividis", "coolwarm"],
                        help="Colormap for visualization")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs on the "
                             "CPU)")
    return parser.parse_args(argv)


def _random_pe_model(method, args):
    """Fresh randomly-initialized PE state (no checkpoint), the reference's
    default when no model is loaded."""
    cfg = ViTConfig(
        img_size=args.grid_size * 4, patch_size=4, embed_dim=args.dim,
        num_heads=args.num_heads, depth=1, pos_encoding=method,
        poly_degree=args.poly_degree, poly_shared_heads=args.poly_shared_heads,
        rope_theta=args.rope_theta)
    mod = pe_registry.get(method)
    params = {k: v.numpy() for k, v in
              mod.init_params(torch.Generator().manual_seed(0), cfg).items()}
    params.update({k: v.numpy() for k, v in mod.buffers(cfg).items()})
    return introspect.PEModel(method, params, args.dim, args.num_heads,
                              args.dim // args.num_heads, args.grid_size)


def _pyplot():
    """matplotlib.pyplot on the Agg backend, imported at the first figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, args, stem):
    plt = _pyplot()
    os.makedirs(args.output_dir, exist_ok=True)
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    path = os.path.join(args.output_dir, f"{stem}_{ts}.png")
    fig.savefig(path, dpi=args.dpi, bbox_inches="tight")
    plt.close(fig)
    print(f"Saved visualization to {path}")
    return path


def _model_theta(method, args):
    """The reference's single/compare-mode semantics: rope-axial is
    visualized with theta 100.0 and rope-mixed with 10.0 whatever
    --rope_theta says."""
    if method == "rope-axial":
        return 100.0
    if method == "rope-mixed":
        return 10.0
    return args.rope_theta


def _panel_block(ax, block, grid, cmap):
    """Block-matrix heatmap panel with the reference's decorations: fixed
    [-1, 1] range, white minor gridlines at block boundaries, major ticks
    at block centers labeled 1..grid."""
    im = ax.imshow(block, cmap=cmap, vmin=-1, vmax=1)
    ax.set_xticks(np.arange(-0.5, grid ** 2, grid), minor=True)
    ax.set_yticks(np.arange(-0.5, grid ** 2, grid), minor=True)
    ax.grid(which="minor", color="w", linestyle="-", linewidth=0.5)
    ax.set_xticks(np.arange(grid // 2, grid ** 2, grid))
    ax.set_yticks(np.arange(grid // 2, grid ** 2, grid))
    ax.set_xticklabels(range(1, grid + 1))
    ax.set_yticklabels(range(1, grid + 1))
    return im


def visualize_grid(sim, grid, method, model_name, args):
    """Per-position grid of heatmaps: cell (i, j) shows how position (i, j)
    relates to every other position. Rendered as the reference renders it:
    fixed [-1, 1] color range, thin black cell borders, edge row/column
    labels, one shared 'Cosine similarity' colorbar, and the reference's
    title, axis text and output filename."""
    plt = _pyplot()
    sim4 = sim.reshape(grid, grid, grid, grid)
    fig, axes = plt.subplots(grid, grid, figsize=(2 * grid, 2 * grid),
                             sharex=True, sharey=True)
    axes = np.atleast_1d(axes).flatten()
    for pos in range(grid * grid):
        i, j = divmod(pos, grid)
        ax = axes[pos]
        im = ax.imshow(sim4[i, j], cmap=args.cmap, vmin=-1, vmax=1)
        ax.set_xticks([])
        ax.set_yticks([])
        for spine in ax.spines.values():
            spine.set_visible(True)
            spine.set_color("black")
            spine.set_linewidth(0.5)
        if j == 0:
            ax.set_ylabel(f"{i + 1}", fontsize=8)
        if i == grid - 1:
            ax.set_xlabel(f"{j + 1}", fontsize=8)
    cbar_ax = fig.add_axes([0.92, 0.15, 0.02, 0.7])
    fig.colorbar(im, cax=cbar_ax).set_label("Cosine similarity")
    fig.suptitle(f"{method.capitalize()} Position Embeddings - From model: "
                 f"{model_name} ({grid}x{grid})", fontsize=16, y=0.98)
    fig.subplots_adjust(wspace=0.1, hspace=0.1, right=0.9)
    fig.text(0.5, 0.01, "Input patch column", ha="center", fontsize=12)
    fig.text(0.01, 0.5, "Input patch row", va="center",
             rotation="vertical", fontsize=12)
    return _save(fig, args, f"pe_similarity_grid_{model_name}_{method}")


def visualize_compact(sim, grid, method, model_name, args):
    """Compact block-matrix view, as the reference renders it."""
    block = similarity.block_matrix(sim, grid)
    fig, ax = _pyplot().subplots(figsize=(10, 8))
    im = _panel_block(ax, block, grid, args.cmap)
    ax.set_xlabel("Input patch column")
    ax.set_ylabel("Input patch row")
    fig.colorbar(im, ax=ax).set_label("Cosine similarity")
    ax.set_title(f"{method.capitalize()} Position Embeddings\nFrom model: "
                 f"{model_name} ({grid}x{grid})", fontsize=14)
    return _save(fig, args, f"pe_similarity_compact_{model_name}_{method}")


def visualize_comparison(panels, args):
    """Side-by-side block-matrix comparison of panels [(name, sim, grid)],
    as the reference renders it: per-panel block gridlines + center ticks +
    '{name} ({g}x{g})' titles, first-panel ylabel only, shared labeled
    colorbar."""
    plt = _pyplot()
    n = len(panels)
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 5))
    axes = np.atleast_1d(axes).flatten()
    for i, (ax, (name, sim, grid)) in enumerate(zip(axes, panels)):
        im = _panel_block(ax, similarity.block_matrix(sim, grid), grid,
                          args.cmap)
        ax.set_title(f"{name} ({grid}x{grid})")
        if i == 0:
            ax.set_ylabel("Input patch row")
    fig.text(0.5, 0.01, "Input patch column", ha="center")
    cbar_ax = fig.add_axes([0.92, 0.15, 0.02, 0.7])
    fig.colorbar(im, cax=cbar_ax).set_label("Cosine similarity")
    plt.tight_layout(rect=[0, 0.03, 0.9, 0.95])
    fig.suptitle("Positional Encoding Comparison", fontsize=16)
    return _save(fig, args, "pe_model_comparison")


def _comparison(models, names, args):
    """The comparison's panels, each model at its rope theta pin."""
    return ("comparison", ([
        (name, *similarity.similarity_for(
            model, head_idx=args.rope_head_idx, num_heads=args.num_heads,
            rope_theta=_model_theta(model.method, args), device=args.device))
        for model, name in zip(models, names)],))


def _load_models_tolerant(triples, args):
    """Load (path, method, display_name) checkpoints for comparison,
    warning and SKIPPING any that fail to load or shape-check, as the
    reference's multi-model mode does instead of aborting the whole
    comparison. Display names stay aligned with their surviving models."""
    models, names = [], []
    for path, method, name in triples:
        try:
            models.append(introspect.load_pe_model(
                path, method, args.grid_size, args.num_heads))
            names.append(name)
        except Exception as e:  # noqa: BLE001 — tool-level resilience
            print(f"Warning: could not load {path} as '{method}': {e}")
            print(f"Skipping {method}.")
    return models, names


def figures(args):
    """What main() draws for args, computed on args.device: a list of
    (kind, data), kind "grid" / "compact" with data (sim, grid, method,
    model_name) or "comparison" with data ([(name, sim, grid)],)."""
    if args.compare_models and args.model_paths:
        configs = args.model_configs or [args.model_config] * len(
            args.model_paths)
        # The reference's naming: an explicit --model_names entry when
        # present at that index, else the checkpoint's filename stem.
        display = [args.model_names[i]
                   if args.model_names and i < len(args.model_names)
                   else os.path.splitext(os.path.basename(p))[0]
                   for i, p in enumerate(args.model_paths)]
        models, names = _load_models_tolerant(
            list(zip(args.model_paths, configs, display)), args)
        if not models:
            raise SystemExit("No models could be loaded for comparison.")
        return [_comparison(models, names, args)]

    if args.load_model and args.model_path:
        # The reference's single-model semantics: titles and filenames use
        # the checkpoint's filename stem, and rope modes pin their
        # visualization theta (axial 100.0, mixed 10.0).
        model_name = os.path.splitext(os.path.basename(args.model_path))[0]
        theta = _model_theta(args.model_config, args)
        if theta != args.rope_theta:
            print(f"Using rope_theta={theta} for {model_name} "
                  f"({args.model_config})")
        model = introspect.load_pe_model(
            args.model_path, args.model_config, args.grid_size,
            args.num_heads)
        sim, grid = similarity.similarity_for(
            model, head_idx=args.rope_head_idx, num_heads=args.num_heads,
            rope_theta=theta, device=args.device)
        data = (sim, grid, model.method, model_name)
        return [("grid", data), ("compact", data)]

    # Auto-discovery, as in the reference: trained CIFAR-10 checkpoints
    # under ./checkpoints flip the tool into comparison mode, displayed
    # under their capitalized method names.
    found = introspect.discover_checkpoints("checkpoints", args.methods)
    if found:
        print(f"Auto-discovered checkpoints: {sorted(found)}")
        models, names = _load_models_tolerant(
            [(p, m, m.capitalize()) for m, p in found.items()], args)
        if models:
            return [_comparison(models, names, args)]
        print("No discovered checkpoint could be loaded; falling back to "
              "random-init visualization.")

    # No checkpoints: randomly-initialized encodings per method.
    out = []
    for method in args.methods:
        model = _random_pe_model(method, args)
        sim, grid = similarity.similarity_for(
            model, head_idx=args.rope_head_idx, num_heads=args.num_heads,
            rope_theta=args.rope_theta, device=args.device)
        data = (sim, grid, method, "random_init")
        out += [("grid", data), ("compact", data)]
    return out


def main(argv=None):
    """Draws figures(args); returns the PNG paths written."""
    args = get_args(argv)
    args.device = resolve_device(args.device)
    draw = {"grid": visualize_grid, "compact": visualize_compact,
            "comparison": visualize_comparison}
    return [draw[kind](*data, args=args) for kind, data in figures(args)]


if __name__ == "__main__":
    main()
