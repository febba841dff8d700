"""Multi-device execution: the device mesh (``mesh.py``) and the
multi-process seam over ``torch.distributed`` (``multihost.py``)."""

from vit_colmap_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    get_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
from vit_colmap_tpu_torch.parallel.multihost import (
    initialize as initialize_multihost,
    is_primary,
    local_image_slice,
)
