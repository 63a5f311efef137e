"""Headless check: camera-trajectory synthesis -> PNG path plot + views.

    python -m morefusion_tpu_torch.checks.check_camera_trajectory
        [--out-dir DIR]

Port of ``checks/check_camera_trajectory.py``: sphere-sampled viewpoints
of a seed-3 scene, KD-sorted into a smooth path and pose-interpolated
(``random_camera_trajectory(6, 5)``), drawn as a top-down path plot (plain
numpy rasterization) and rendered at its first, middle and last pose; then
``uniform_points_on_sphere(8, 0.6)``. Host only (``--device`` is accepted
and unused). ``main`` returns the eye positions, the step lengths and both
images.
"""

from __future__ import annotations

import numpy as np

from . import _common


def path_plot(eyes, objects, H=400, W=400):
    """The top-down plot: the eyes' path (red start, blue segments) and
    the objects as green dots."""
    plot = np.full((H, W, 3), 255, np.uint8)
    xy = eyes[:, :2]
    lo, hi = xy.min(0) - 0.05, xy.max(0) + 0.05
    px = ((xy - lo) / (hi - lo) * (W - 20) + 10).astype(int)
    for k in range(len(px) - 1):
        n = 20
        for t in range(n + 1):
            x, y = (px[k] * (n - t) + px[k + 1] * t) // n
            plot[np.clip(H - 1 - y, 0, H - 1), np.clip(x, 0, W - 1)] = (
                (200, 60, 60) if t == 0 else (60, 60, 200)
            )
    for obj in objects:
        p = obj["T_cad2world"][:2, 3]
        x, y = ((p - lo) / (hi - lo) * (W - 20) + 10).astype(int)
        yy, xx = np.clip(H - 1 - y, 2, H - 3), np.clip(x, 2, W - 3)
        plot[yy - 2 : yy + 3, xx - 2 : xx + 3] = (40, 160, 40)
    return plot


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    from .. import geometry
    from ..datasets import ProceduralModels
    from ..extra import viz
    from ..simulation import PlaneTypeSceneGeneration

    models = ProceduralModels()
    gen = PlaneTypeSceneGeneration(
        models, n_object=4, random_state=np.random.RandomState(3)
    )
    gen.generate()
    traj = gen.random_camera_trajectory(n_keypoints=6, n_points=5)
    eyes = np.stack([T[:3, 3] for T in traj])
    print(f"trajectory: {len(traj)} poses, eye z range "
          f"[{eyes[:, 2].min():.2f}, {eyes[:, 2].max():.2f}]")
    plot = path_plot(eyes, gen.objects.values())

    views = []
    for idx in (0, len(traj) // 2, len(traj) - 1):
        frame = gen.render_frame(traj[idx], shape=(200, 200))
        views.append(frame["rgb"])

    # interpolation sanity: consecutive eyes move smoothly
    step = np.linalg.norm(np.diff(eyes, axis=0), axis=1)
    print(f"step lengths: mean {step.mean():.3f} max {step.max():.3f}")

    path_png = _common.out_path(args, "trajectory_path.png")
    viz.save_image(path_png, plot)
    views_image = viz.tile_images(views, cols=3)
    viz.save_image(_common.out_path(args, "trajectory_views.png"),
                   views_image)
    # smoke the low-level helpers too (grid sampling with pole dedup)
    pts = geometry.uniform_points_on_sphere(8, radius=0.6)
    assert pts.ndim == 2 and pts.shape[1] == 3
    assert np.allclose(np.linalg.norm(pts, axis=1), 0.6, atol=1e-6)
    print("wrote", path_png)
    return dict(eyes=eyes, step=step, path=plot, views=views_image)


if __name__ == "__main__":
    main()
