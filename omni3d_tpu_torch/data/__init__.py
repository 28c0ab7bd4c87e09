"""Data layer: Omni3D loader, filters, 3D-aware mapper, samplers, batching
(port of `omni3d_tpu.data`, with its own image reading and resizing)."""
from .builtin import get_omni3d_categories  # noqa: F401
from .datasets import (Omni3D, get_dataset, get_filter_settings_from_cfg,  # noqa: F401
                       is_ignore, load_omni3d_json, metadata,
                       register_and_store_model_metadata, register_dataset,
                       simple_register)
from .image import read_image_bgr, resize_bilinear_uint8  # noqa: F401
from .mapper import (DatasetMapper3D, batch_to_device, collate_batch,  # noqa: F401
                     pad_to_bucket, resize_shortest_edge)
from .build import (build_detection_test_loader,  # noqa: F401
                    build_detection_train_loader,
                    get_detection_dataset_dicts)
