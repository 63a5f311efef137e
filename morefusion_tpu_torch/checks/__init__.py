"""Headless visual self-tests of the port, one module a check.

Ports of the JAX package's ``checks/*.py`` scripts: each writes the same
artifacts (PNG / OBJ) and prints the same lines as its script, into
``--out-dir`` (default ``/tmp/mftpu_torch_checks``, apart from the JAX
scripts' ``/tmp/mftpu_checks``), and its ``main(argv=None)`` returns the
numbers and images it printed and wrote. Run one with

    python -m morefusion_tpu_torch.checks.<name> [--device cuda|cpu]
        [--out-dir DIR]

Three reach the card at the default ``--device cuda``:
``check_augmentation`` (the device augmentation), ``check_occupancy_
voxelization`` (the min-distance kernel with its payload) and
``check_icp_convergence`` (the nearest-neighbour kernel every ICP
iteration); ``check_segmentation_instances`` runs the device connected
components beside the host instancing. The other four are host work and
accept ``--device`` for a common interface.
"""

#: the module names, in the order they depend on each other's code
CHECKS = (
    "check_scene_generation",
    "check_camera_trajectory",
    "check_mapping_render",
    "check_segmentation_instances",
    "check_dataset_browse",
    "check_augmentation",
    "check_occupancy_voxelization",
    "check_icp_convergence",
)
