"""Hand-written CUDA kernels for Hopper (sm_90a), their wrappers and their
plain PyTorch versions.

``segconv``  segmented overlap-save convolution  (csrc/segconv.cu)
``convpairs`` circular convolution of real rows, the streaming window
             (csrc/convpairs.cu; both share csrc/window_fft.cuh)
``tail``     fused delay/tremolo/waveshaper tail (csrc/tail.cu)
``relayout`` natural <-> time-major pack / unpack (csrc/relayout.cu; the
             walks' plain version uses them, no path launches them)
``dynamics`` speculative compressor/gate walks and the serial walk of the
             streaming step, and the offline fixpoint's settle step
                                                 (csrc/dynamics.cu)
``graph_cond`` a conditional while node in a CUDA graph being captured,
             and the record of the fixpoints run in one (csrc/graph_cond.cu)
``_build``   compiles csrc/*.cu with nvcc at first use and loads them with
             ctypes (csrc/trace_mark.cu too: the graphs' stage mark, which
             ``profiling.mark`` launches)

Importing these modules needs neither ``nvcc`` nor a card: a kernel is built
and loaded inside the call that first launches it.
"""
