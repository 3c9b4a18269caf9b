"""Share of its roofline that the register-list kernel
(``csrc/dense_topk.cu dense_topk_tc_kernel``) reaches in the window, %."""

from benchmark.readers import Run, kernel_roofline


def read(run: Run):
    return kernel_roofline(run, "dense_topk_tc_kernel")
