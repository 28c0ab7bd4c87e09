"""Canonical Omni3D category tables (copy of `omni3d_tpu.data.builtin`).

Same public data as the reference (cubercnn/data/builtin.py:3-56): the set of
categories annotated in each Omni3D sub-dataset and the three benchmark-level
unions. Category names are benchmark constants, reproduced verbatim.
"""

_OMNI3D = {
    'chair', 'table', 'cabinet', 'car', 'lamp', 'books', 'sofa', 'pedestrian',
    'picture', 'window', 'pillow', 'truck', 'door', 'blinds', 'sink', 'shelves',
    'television', 'shoes', 'cup', 'bottle', 'bookcase', 'laptop', 'desk',
    'cereal box', 'floor mat', 'traffic cone', 'mirror', 'barrier', 'counter',
    'camera', 'bicycle', 'toilet', 'bus', 'bed', 'refrigerator', 'trailer',
    'box', 'oven', 'clothes', 'van', 'towel', 'motorcycle', 'night stand',
    'stove', 'machine', 'stationery', 'bathtub', 'cyclist', 'curtain', 'bin',
}

_OMNI3D_IN = {
    'stationery', 'sink', 'table', 'floor mat', 'bottle', 'bookcase', 'bin',
    'blinds', 'pillow', 'bicycle', 'refrigerator', 'night stand', 'chair',
    'sofa', 'books', 'oven', 'towel', 'cabinet', 'window', 'curtain',
    'bathtub', 'laptop', 'desk', 'television', 'clothes', 'stove', 'cup',
    'shelves', 'box', 'shoes', 'mirror', 'door', 'picture', 'lamp', 'machine',
    'counter', 'bed', 'toilet',
}

_OMNI3D_OUT = {
    'cyclist', 'pedestrian', 'trailer', 'bus', 'motorcycle', 'car', 'barrier',
    'truck', 'van', 'traffic cone', 'bicycle',
}

_SUNRGBD = {
    'bicycle', 'books', 'bottle', 'chair', 'cup', 'laptop', 'shoes', 'towel',
    'blinds', 'window', 'lamp', 'shelves', 'mirror', 'sink', 'cabinet',
    'bathtub', 'door', 'toilet', 'desk', 'box', 'bookcase', 'picture',
    'table', 'counter', 'bed', 'night stand', 'pillow', 'sofa', 'television',
    'floor mat', 'curtain', 'clothes', 'stationery', 'refrigerator', 'bin',
    'stove', 'oven', 'machine',
}

_HYPERSIM = {
    'books', 'chair', 'towel', 'blinds', 'window', 'lamp', 'shelves',
    'mirror', 'sink', 'cabinet', 'bathtub', 'door', 'toilet', 'desk', 'box',
    'bookcase', 'picture', 'table', 'counter', 'bed', 'night stand',
    'pillow', 'sofa', 'television', 'floor mat', 'curtain', 'clothes',
    'stationery', 'refrigerator',
}

_ARKIT = {
    'table', 'bed', 'sofa', 'television', 'refrigerator', 'chair', 'oven',
    'machine', 'stove', 'shelves', 'sink', 'cabinet', 'bathtub', 'toilet',
}

_OBJECTRON = {
    'bicycle', 'books', 'bottle', 'camera', 'cereal box', 'chair', 'cup',
    'laptop', 'shoes',
}

_KITTI = {'pedestrian', 'car', 'cyclist', 'van', 'truck'}

_NUSCENES = {
    'pedestrian', 'car', 'truck', 'traffic cone', 'barrier', 'motorcycle',
    'bicycle', 'bus', 'trailer',
}

_TABLE = {
    'omni3d': (_OMNI3D, 50),
    'omni3d_in': (_OMNI3D_IN, 38),
    'omni3d_out': (_OMNI3D_OUT, 11),
    'SUNRGBD_train': (_SUNRGBD, 38), 'SUNRGBD_val': (_SUNRGBD, 38), 'SUNRGBD_test': (_SUNRGBD, 38),
    'Hypersim_train': (_HYPERSIM, 29), 'Hypersim_val': (_HYPERSIM, 29),
    'Hypersim_test': (_HYPERSIM - {'toilet'}, 28),  # test split has no toilet
    'ARKitScenes_train': (_ARKIT, 14), 'ARKitScenes_val': (_ARKIT, 14), 'ARKitScenes_test': (_ARKIT, 14),
    'Objectron_train': (_OBJECTRON, 9), 'Objectron_val': (_OBJECTRON, 9), 'Objectron_test': (_OBJECTRON, 9),
    'KITTI_train': (_KITTI, 5), 'KITTI_val': (_KITTI, 5), 'KITTI_test': (_KITTI, 5),
    'nuScenes_train': (_NUSCENES, 9), 'nuScenes_val': (_NUSCENES, 9), 'nuScenes_test': (_NUSCENES, 9),
}


def get_omni3d_categories(dataset: str = "omni3d") -> set:
    """Category set annotated in `dataset` (reference builtin.py:3-56)."""
    if dataset not in _TABLE:
        raise ValueError(f"{dataset} dataset is not registered.")
    cats, n = _TABLE[dataset]
    assert len(cats) == n
    return set(cats)
