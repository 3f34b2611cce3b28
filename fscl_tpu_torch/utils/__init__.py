from fscl_tpu_torch.utils.tool import (
    expand, pad_1d_list, seed_all, ssl_match_length,
)
