"""Omni3D dataset loading, merging, and filtering (host side).

Port of `omni3d_tpu.data.datasets`, line for line (plain Python and numpy),
itself a re-implementation of the reference data core
(cubercnn/data/datasets.py): the Omni3D COCO-superset loader that merges
multiple per-dataset jsons, the `is_ignore` annotation filter, and the
detectron2-dict conversion — without pycocotools or detectron2 catalogs.
A tiny module-level catalog replaces DatasetCatalog/MetadataCatalog.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

# ------------------------------ catalogs ------------------------------

_DATASET_CATALOG: dict = {}
_METADATA_CATALOG: dict = {}


def register_dataset(name: str, loader):
    _DATASET_CATALOG[name] = loader


def get_dataset(name: str):
    return _DATASET_CATALOG[name]()


def metadata(name: str) -> dict:
    return _METADATA_CATALOG.setdefault(name, {})


def xyxy_to_xywh(b):
    return [b[0], b[1], b[2] - b[0], b[3] - b[1]]


def get_filter_settings_from_cfg(cfg=None) -> dict:
    """reference datasets.py:52-79."""
    if cfg is None:
        return {
            "category_names": [],
            "ignore_names": [],
            "truncation_thres": 0.99,
            "visibility_thres": 0.01,
            "min_height_thres": 0.00,
            "max_height_thres": 1.50,
            "modal_2D_boxes": False,
            "trunc_2D_boxes": False,
            "max_depth": 1e8,
        }
    return {
        "category_names": list(cfg.DATASETS.CATEGORY_NAMES),
        "ignore_names": list(cfg.DATASETS.IGNORE_NAMES),
        "truncation_thres": cfg.DATASETS.TRUNCATION_THRES,
        "visibility_thres": cfg.DATASETS.VISIBILITY_THRES,
        "min_height_thres": cfg.DATASETS.MIN_HEIGHT_THRES,
        "modal_2D_boxes": cfg.DATASETS.MODAL_2D_BOXES,
        "trunc_2D_boxes": cfg.DATASETS.TRUNC_2D_BOXES,
        "max_depth": cfg.DATASETS.MAX_DEPTH,
        "max_height_thres": 1.50,
    }


def _pick_bbox2d(anno, filter_settings):
    """2D box source priority (reference datasets.py:99-111): modal tight ->
    truncated -> projected. Returns XYWH or None."""
    if (filter_settings.get("modal_2D_boxes") and "bbox2D_tight" in anno
            and anno["bbox2D_tight"][0] != -1):
        return xyxy_to_xywh(anno["bbox2D_tight"])
    if (filter_settings.get("trunc_2D_boxes") and "bbox2D_trunc" in anno
            and not all(v == -1 for v in anno["bbox2D_trunc"])):
        return xyxy_to_xywh(anno["bbox2D_trunc"])
    if "bbox2D_proj" in anno:
        return xyxy_to_xywh(anno["bbox2D_proj"])
    return anno.get("bbox")


def is_ignore(anno: dict, filter_settings: dict, image_height: float) -> bool:
    """Annotation-level ignore rules (reference datasets.py:82-122)."""
    ignore = bool(anno["behind_camera"])
    ignore |= not bool(anno["valid3D"])
    if ignore:
        return True
    ignore |= anno["dimensions"][0] <= 0
    ignore |= anno["dimensions"][1] <= 0
    ignore |= anno["dimensions"][2] <= 0
    ignore |= anno["center_cam"][2] > filter_settings["max_depth"]
    ignore |= anno["lidar_pts"] == 0
    ignore |= anno["segmentation_pts"] == 0
    ignore |= anno["depth_error"] > 0.5

    bbox2D = _pick_bbox2d(anno, filter_settings)
    ignore |= bbox2D[3] <= filter_settings["min_height_thres"] * image_height
    ignore |= bbox2D[3] >= filter_settings["max_height_thres"] * image_height

    ignore |= anno["truncation"] >= 0 and anno["truncation"] >= filter_settings["truncation_thres"]
    ignore |= anno["visibility"] >= 0 and anno["visibility"] <= filter_settings["visibility_thres"]
    if "ignore_names" in filter_settings:
        ignore |= anno["category_name"] in filter_settings["ignore_names"]
    return bool(ignore)


class Omni3D:
    """COCO-superset index over one or more Omni3D jsons
    (reference datasets.py:140-292): merges annotations/images, unions
    categories, and annotates each kept annotation with area/ignore/bbox."""

    def __init__(self, annotation_files, filter_settings=None):
        if isinstance(annotation_files, str):
            annotation_files = [annotation_files]

        self.dataset = {}
        cats_ids_master, cats_master = [], []

        for path in annotation_files:
            with open(path) as f:
                ds = json.load(f)
            if isinstance(ds.get("info"), list):
                ds["info"] = ds["info"][0]
            ds["info"]["known_category_ids"] = [c["id"] for c in ds["categories"]]
            if not self.dataset:
                self.dataset = ds
            else:
                if isinstance(self.dataset["info"], dict):
                    self.dataset["info"] = [self.dataset["info"]]
                self.dataset["info"] += [ds["info"]]
                self.dataset["annotations"] += ds["annotations"]
                self.dataset["images"] += ds["images"]
            for cat in ds["categories"]:
                if cat["id"] not in cats_ids_master:
                    cats_ids_master.append(cat["id"])
                    cats_master.append(cat)

        order = np.argsort(cats_ids_master)
        if filter_settings is None:
            self.dataset["categories"] = [cats_master[i] for i in order]
        else:
            trainable = set(filter_settings["ignore_names"]) | set(
                filter_settings["category_names"]
            )
            if filter_settings["category_names"]:
                self.dataset["categories"] = [
                    cats_master[i] for i in order
                    if cats_master[i]["name"] in filter_settings["category_names"]
                ]
            else:
                self.dataset["categories"] = [cats_master[i] for i in order]
                filter_settings["category_names"] = [
                    c["name"] for c in self.dataset["categories"]
                ]
                trainable |= set(filter_settings["category_names"])

            im_height = {im["id"]: im["height"] for im in self.dataset["images"]}
            valid = []
            for anno in self.dataset["annotations"]:
                ignore = is_ignore(anno, filter_settings, im_height[anno["image_id"]])
                bbox2D = None
                if (filter_settings["trunc_2D_boxes"] and "bbox2D_trunc" in anno
                        and not all(v == -1 for v in anno["bbox2D_trunc"])):
                    bbox2D = xyxy_to_xywh(anno["bbox2D_trunc"])
                elif anno.get("bbox2D_proj", [-1])[0] != -1:
                    bbox2D = xyxy_to_xywh(anno["bbox2D_proj"])
                elif anno.get("bbox2D_tight", [-1])[0] != -1:
                    bbox2D = xyxy_to_xywh(anno["bbox2D_tight"])
                else:
                    continue
                anno["area"] = bbox2D[2] * bbox2D[3]
                anno["iscrowd"] = False
                anno["ignore"] = ignore
                anno["ignore2D"] = ignore
                anno["ignore3D"] = ignore
                if filter_settings["modal_2D_boxes"] and anno.get("bbox2D_tight", [-1])[0] != -1:
                    anno["bbox"] = xyxy_to_xywh(anno["bbox2D_tight"])
                else:
                    anno["bbox"] = bbox2D
                anno["bbox3D"] = anno["bbox3D_cam"]
                anno["depth"] = anno["center_cam"][2]
                if anno["category_name"] in trainable:
                    valid.append(anno)
            self.dataset["annotations"] = valid

        self._create_index()

    def _create_index(self):
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.imgToAnns, self.catToImgs = defaultdict(list), defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.imgToAnns[ann["image_id"]].append(ann)
            self.catToImgs[ann["category_id"]].append(ann["image_id"])
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    # minimal pycocotools-compatible surface
    def getAnnIds(self, imgIds=None, catIds=None):
        anns = self.dataset.get("annotations", [])
        if imgIds is not None:
            ids = set(imgIds if isinstance(imgIds, (list, tuple)) else [imgIds])
            anns = [a for a in anns if a["image_id"] in ids]
        if catIds is not None:
            ids = set(catIds if isinstance(catIds, (list, tuple)) else [catIds])
            anns = [a for a in anns if a["category_id"] in ids]
        return [a["id"] for a in anns]

    def getImgIds(self, imgIds=None, catIds=None):
        # pycocotools semantics: empty/None filter = all; catIds INTERSECT
        # (images containing every requested category)
        imgs = list(self.imgs.keys())
        if imgIds:
            ids = set(imgIds if isinstance(imgIds, (list, tuple)) else [imgIds])
            imgs = [i for i in imgs if i in ids]
        if catIds:
            cats = catIds if isinstance(catIds, (list, tuple)) else [catIds]
            for c in cats:
                has = set(self.catToImgs.get(c, []))
                imgs = [i for i in imgs if i in has]
        return imgs

    def loadAnns(self, ids):
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids):
        return [self.imgs[i] for i in ids]

    def getCatIds(self, catNms=None):
        cats = self.dataset.get("categories", [])
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        return [c["id"] for c in cats]

    def loadCats(self, ids):
        return [self.cats[i] for i in ids]


def register_and_store_model_metadata(output_dir, filter_settings, stats_path=None):
    """Fix the model's category ordering (reference datasets.py:294-327):
    thing classes sorted by their global Omni3D category id, persisted to
    category_meta.json so eval/demo share the exact id map."""
    output_file = os.path.join(output_dir, "category_meta.json")
    if os.path.exists(output_file):
        with open(output_file) as f:
            meta = json.load(f)
        thing_classes = meta["thing_classes"]
        id_map = {int(k): v for k, v in meta["thing_dataset_id_to_contiguous_id"].items()}
    else:
        if stats_path is None:
            stats_path = os.path.join("datasets", "Omni3D", "stats.json")
        with open(stats_path) as f:
            stats = json.load(f)
        thing_classes = list(filter_settings["category_names"])
        cat_ids = [
            stats["categories"][stats["category_names"].index(c)]["id"]
            for c in thing_classes
        ]
        order = np.argsort(cat_ids)
        cat_ids = [cat_ids[i] for i in order]
        thing_classes = [thing_classes[i] for i in order]
        id_map = {cid: i for i, cid in enumerate(cat_ids)}
        os.makedirs(output_dir, exist_ok=True)
        with open(output_file, "w") as f:
            json.dump({"thing_classes": thing_classes,
                       "thing_dataset_id_to_contiguous_id": id_map}, f)

    m = metadata("omni3d_model")
    m["thing_classes"] = thing_classes
    m["thing_dataset_id_to_contiguous_id"] = id_map
    return thing_classes, id_map


def load_omni3d_json(json_file, image_root, dataset_name, filter_settings,
                     filter_empty=False):
    """Json -> list of per-image records (reference datasets.py:330-448).

    Records carry file_name/height/width/K plus `annotations` with XYXY bbox,
    3D center/dims/pose, and category_id == -1 for ignores.
    """
    api = Omni3D([json_file])  # unfiltered index for this dataset

    meta_model = metadata("omni3d_model")
    id_map = meta_model["thing_dataset_id_to_contiguous_id"]

    meta = metadata(dataset_name)
    cat_ids = sorted(api.getCatIds(filter_settings["category_names"]))
    meta["thing_classes"] = [c["name"] for c in sorted(api.loadCats(cat_ids), key=lambda x: x["id"])]
    meta["thing_dataset_id_to_contiguous_id"] = id_map
    meta["json_file"] = json_file

    records = []
    invalid = 0
    for img_id in sorted(api.imgs.keys()):
        img = api.imgs[img_id]
        record = {
            "file_name": os.path.join(image_root, img["file_path"]),
            "dataset_id": img["dataset_id"],
            "height": img["height"],
            "width": img["width"],
            "K": img["K"],
            "image_id": img_id,
        }
        if "p2" in img:
            record["p2"] = img["p2"]
        objs = []
        has_valid = False
        for anno in api.imgToAnns[img_id]:
            cat_id = anno["category_id"]
            if cat_id not in id_map and anno["category_name"] not in filter_settings["ignore_names"]:
                continue
            ignore = is_ignore(anno, filter_settings, img["height"])
            bbox = _pick_bbox2d(anno, filter_settings)
            if bbox is None:
                continue
            x, y, w, h = bbox
            objs.append({
                "bbox": [x, y, x + w, y + h],  # XYXY
                "category_id": -1 if ignore else id_map.get(cat_id, -1),
                "center_cam": anno["center_cam"],
                "dimensions": anno["dimensions"],
                "pose": anno["R_cam"],
                "bbox3D_cam": anno["bbox3D_cam"],
                "ignore": ignore,
            })
            has_valid |= not ignore
        if has_valid or not filter_empty:
            record["annotations"] = objs
            records.append(record)
        else:
            invalid += 1
    return records


def simple_register(dataset_name, filter_settings, filter_empty=False,
                    datasets_root_path=None):
    """reference datasets.py:125-138."""
    if datasets_root_path is None:
        datasets_root_path = os.path.join("datasets", "Omni3D")
        image_root = "datasets"
    else:
        # json dir is <root>/Omni3D; images live under <root>/ (reference
        # layout: datasets/Omni3D/*.json + datasets/<dataset>/... images)
        image_root = os.path.dirname(os.path.abspath(datasets_root_path))
    path_to_json = os.path.join(datasets_root_path, dataset_name + ".json")
    register_dataset(dataset_name, lambda: load_omni3d_json(
        path_to_json, image_root, dataset_name, filter_settings, filter_empty
    ))
    meta = metadata(dataset_name)
    meta["json_file"] = path_to_json
    meta["image_root"] = image_root
    meta["evaluator_type"] = "coco"
