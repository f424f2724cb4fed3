from .streaming import loss_fn_streaming
from .quadrature import expected_nll_rows_gh, hermgauss
