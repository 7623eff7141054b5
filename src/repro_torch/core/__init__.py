"""repro_torch.core — the paper's device and cost models (port of
``repro.core``): Eq. 3 switching physics and the device-realism profile
(``physics``), the pop-count strategies (``popcount``) and the §V
closed-form cycle / energy / area model (``costmodel``)."""
