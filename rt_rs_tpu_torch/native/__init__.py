"""Native C++ fast paths: the median-split BVH builder and the OBJ
parser (counterpart of ``rt_rs_tpu/native``).

:func:`rt_rs_tpu_torch.bvh.build_bvh` and
:func:`rt_rs_tpu_torch.scene.obj.load_obj` take them unless
``RT_NATIVE=0``; their output equals the NumPy builder's and the Python
parser's bit for bit.  The library is built at first use
(:mod:`.build`).
"""
