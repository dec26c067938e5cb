from ia_spgemm_tpu.models.matnet import forward, predict_class  # noqa: F401
from ia_spgemm_tpu.models.weights import (  # noqa: F401
    load_keras_h5,
    import_reference_weights,
)
