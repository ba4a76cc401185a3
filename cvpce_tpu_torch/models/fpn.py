"""FPN + P6/P7 (torch); counterpart of cvpce_tpu/models/fpn.py:FPN.
Lateral 1x1 convs on C3..C5, nearest 2x top-down merges, 3x3 output
convs, P6 = 3x3/s2 on P5, P7 = 3x3/s2 on relu(P6). `quant` runs every
conv as an int8 conv (models/quant.py); outputs are in `dtype`."""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import cast_float_convs_, conv, upsample_nearest_2x
from .quant import qconv


class FPN(nn.Module):
    IN_CHANNELS = (512, 1024, 2048)  # C3..C5 of ResNet-50

    def __init__(self, quant: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        oc = 256

        def _c(cin, kernel, stride=1):
            if quant:
                return qconv(cin, oc, kernel, stride, bias=True, dtype=dtype,
                             quant=quant)
            return conv(cin, oc, kernel, stride, bias=True)

        for i, cin in enumerate(self.IN_CHANNELS):
            setattr(self, f"inner_{i}", _c(cin, 1))
            setattr(self, f"layer_{i}", _c(oc, 3))
        self.p6 = _c(oc, 3, 2)
        self.p7 = _c(oc, 3, 2)
        cast_float_convs_(self, dtype)

    def forward(self, c3: torch.Tensor, c4: torch.Tensor,
                c5: torch.Tensor) -> List[torch.Tensor]:
        t5 = self.inner_2(c5)
        t4 = self.inner_1(c4) + upsample_nearest_2x(t5)
        t3 = self.inner_0(c3) + upsample_nearest_2x(t4)
        p3 = self.layer_0(t3)
        p4 = self.layer_1(t4)
        p5 = self.layer_2(t5)
        p6 = self.p6(p5)
        p7 = self.p7(F.relu(p6))
        return [p3, p4, p5, p6, p7]
