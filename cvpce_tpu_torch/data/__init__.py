"""Host-side data: the dataset readers on the port's PNG and JPEG
decoders, image transforms, loaders, the record cache and synthetic
planogram scenes; the names of cvpce_tpu/data/__init__.py."""

from . import defaults, transforms  # noqa: F401
from .grocery import (  # noqa: F401
    GPBaselineDataset,
    GroceryProductsDataset,
    GroceryProductsTestSet,
    InternalTrainSet,
    SimpleFolderSet,
)
from .grozi import (  # noqa: F401
    GroZiDataset,
    GroZiTestSet,
    extract_grozi_test_imgs,
)
from .loader import PrefetchLoader  # noqa: F401
from .planograms import (  # noqa: F401
    InternalPlanoSet,
    PlanogramTestSet,
    read_tonioni_planogram,
)
from .sku110k import (  # noqa: F401
    SKU110KDataset,
    TargetDomainDataset,
    collate_detection,
    pad_boxes,
)
