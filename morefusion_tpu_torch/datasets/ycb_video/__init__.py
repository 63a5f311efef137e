"""YCB-Video of the port: the class tables, and (imported on first use,
since they need the data on disk) the CAD bank and the frame datasets."""

# flake8: noqa: F401
from . import class_names as _class_names_module
from .class_names import class_names
from .class_names import class_ids_asymmetric
from .class_names import class_ids_symmetric
from .class_names import class_names_asymmetric
from .class_names import class_names_symmetric
from .class_names import n_fg_classes
from .class_names import symmetric_flags


def __getattr__(name):
    if name == "YCBVideoModels":
        from .models import YCBVideoModels

        return YCBVideoModels
    if name in (
        "YCBVideoDataset",
        "YCBVideoSyntheticDataset",
        "YCBVideoRGBDPoseEstimationDataset",
    ):
        from . import dataset as _d

        return getattr(_d, name)
    raise AttributeError(name)
