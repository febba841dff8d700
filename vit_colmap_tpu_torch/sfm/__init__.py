"""Structure-from-motion: batched two-view geometry and the five-point
solver, PnP, bundle adjustment, the incremental mapper, and the
reconstruction data model with COLMAP IO.

``incremental_mapping`` is imported from
``vit_colmap_tpu_torch.sfm.incremental`` (it pulls in the pipeline's
matching module).
"""

from vit_colmap_tpu_torch.sfm.reconstruction import (  # noqa: F401
    Camera,
    Image,
    Point3D,
    Reconstruction,
    read_text,
)
