"""Dataset path defaults and curated skip lists; a copy of
cvpce_tpu/data/defaults.py (the SKU-110K skip list is dataset metadata
from the reference's outlier scan, cvpce/cli/gln.py:309-377).
"""
import os
from os import path

DATA_DIR = os.environ.get("CVPCE_DATA_DIR", path.join("..", "data"))

SKU110K_IMG_DIR = path.join(DATA_DIR, "SKU110K_fixed", "images")
SKU110K_ANNOTATION_FILE = path.join(
    DATA_DIR, "SKU110K_fixed", "annotations", "annotations_val.csv"
)
SKU110K_SKIP = [
    # corrupted images that won't load
    "test_274.jpg", "train_882.jpg", "train_924.jpg", "train_4222.jpg",
    "train_5822.jpg",
    # corrupted images that load
    "train_789.jpg", "train_5007.jpg", "train_6090.jpg", "train_7576.jpg",
    # missing most ground truth boxes
    "train_104.jpg", "train_890.jpg", "train_1296.jpg", "train_3029.jpg",
    "train_3530.jpg", "train_3622.jpg", "train_4899.jpg", "train_6216.jpg",
    "train_7880.jpg",
    # very poor images
    "train_701.jpg", "train_6566.jpg",
]

GP_ROOT = path.join(DATA_DIR, "Grocery_products")
GP_TRAIN_FOLDERS = (path.join(GP_ROOT, "Training"),)
GP_TEST_DIR = path.join(GP_ROOT, "Testing")
GP_ANN_DIR = path.join(DATA_DIR, "Planogram_Dataset", "annotations")
GP_BASELINE_ANN_FILE = path.join(
    DATA_DIR, "Baseline", "Grocery_products_coco_gt_object.csv"
)
GP_PLANO_DIR = path.join(DATA_DIR, "Planogram_Dataset", "planograms")
GP_TEST_VALIDATION_SET = [
    "s1_15.csv", "s2_3.csv", "s2_30.csv", "s2_143.csv", "s2_157.csv",
    "s3_111.csv", "s3_260.csv", "s5_55.csv",
]
GP_TEST_VALIDATION_SET_SIZE = 2
GP_PLANO_VALIDATION_SET = [f"{s.split('.')[0]}.json"
                           for s in GP_TEST_VALIDATION_SET]

GROZI_ROOT = path.join(DATA_DIR, "GroZi-120")

MODEL_DIR = os.environ.get("CVPCE_MODEL_DIR", path.join("..", "models"))
OUT_DIR = os.environ.get("CVPCE_OUT_DIR", "out")
