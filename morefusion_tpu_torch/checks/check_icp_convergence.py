"""Headless check: ICP convergence traces (fixed and gated) -> PNG.

    python -m morefusion_tpu_torch.checks.check_icp_convergence
        [--device cuda] [--out-dir DIR]

Port of ``checks/check_icp_convergence.py``: class 2's CAD points 0.5 m in
front of the camera, the start pose 8 degrees and up to 1 cm off;
``ICPRegistration.register_iterative`` for 60 single iterations (the ADD
after each) and the gated ``register`` (100 at most), both on ``--device``,
where every iteration launches the nearest-neighbour kernel
(``csrc/knn.cu``). Prints the ADD at the start and the end and where the
gated variant stopped; writes the ADD curve with the gated stop marked.
``main`` returns the ADD per iteration, the gated iteration count and the
image.
"""

from __future__ import annotations

import numpy as np

from . import _common


def curve_image(errs, n_gated, H=240, W=480):
    """The ADD curve (red dots) and the gated stop (a blue column)."""
    img = np.full((H, W, 3), 255, np.uint8)
    e = np.asarray(errs)
    y = ((1 - e / e.max()) * (H - 20) + 10).astype(int)
    x = (np.arange(len(e)) / max(len(e) - 1, 1) * (W - 20) + 10).astype(int)
    for k in range(len(e)):
        img[np.clip(y[k], 0, H - 1), np.clip(x[k], 0, W - 1)] = (200, 40, 40)
    gx = int(n_gated / max(len(e) - 1, 1) * (W - 20) + 10)
    img[:, np.clip(gx, 0, W - 1)] = (60, 60, 200)
    return img


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    import scipy.spatial.transform

    from ..contrib import ICPRegistration
    from ..datasets import ProceduralModels
    from ..extra import viz

    rng = np.random.RandomState(0)
    models = ProceduralModels()
    cad = models.get_pcd(2).astype(np.float32)
    T_true = np.eye(4)
    T_true[:3, 3] = [0, 0, 0.5]
    depth = cad @ T_true[:3, :3].T + T_true[:3, 3]

    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    P = np.eye(4)
    P[:3, :3] = scipy.spatial.transform.Rotation.from_rotvec(
        np.radians(8) * axis
    ).as_matrix()
    P[:3, 3] = rng.uniform(-0.01, 0.01, 3)
    T_init = T_true @ P

    reg = ICPRegistration(depth, cad, T_init, device=args.device)
    errs = []
    for T in reg.register_iterative(iteration=60, voxel_size=0.005):
        errs.append(
            np.linalg.norm(
                (cad @ T[:3, :3].T + T[:3, 3]) - depth, axis=1
            ).mean()
        )
    reg2 = ICPRegistration(depth, cad, T_init, device=args.device)
    reg2.register(iteration=100, voxel_size=0.005)
    n_gated = int(reg2.last_n_iterations)
    print(
        f"ADD: init {errs[0]*1000:.2f} mm -> final {errs[-1]*1000:.3f} mm; "
        f"gated variant stopped at {n_gated} iterations"
    )

    image = curve_image(errs, n_gated)
    out = _common.out_path(args, "icp_convergence.png")
    viz.save_image(out, image)
    print("wrote", out)
    return dict(add=[float(e) for e in errs], n_gated=n_gated, image=image)


if __name__ == "__main__":
    main()
