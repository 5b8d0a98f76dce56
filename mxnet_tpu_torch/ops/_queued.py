"""Op names of the JAX package's registry that the port does not have
yet, by the JAX module that defines them and the ROADMAP queue item that
ports it (A9).
Calling one raises ``MXNetError`` naming its module and item."""

QUEUED_MODULES = {
    "operator.py": ("A9", """
Custom"""),
    "ops/contrib_ops.py": ("A9", """
_contrib_AdaptiveAvgPooling2D _contrib_BilinearResize2D
_contrib_ROIAlign _contrib_RROIAlign _contrib_SparseEmbedding
_contrib_allclose _contrib_arange_like
_contrib_bipartite_matching _contrib_box_iou _contrib_box_nms
_contrib_box_non_maximum_suppression _contrib_count_sketch
_contrib_div_sqrt_dim _contrib_fft _contrib_gradientmultiplier
_contrib_hawkesll _contrib_ifft _contrib_index_array
_contrib_index_copy _contrib_interleaved_matmul_selfatt_qk
_contrib_interleaved_matmul_selfatt_valatt _contrib_quadratic
all_finite multi_all_finite quadratic"""),
    "ops/linalg.py": ("A9", """
_linalg_det _linalg_extractdiag _linalg_extracttrian
_linalg_gelqf _linalg_gemm _linalg_gemm2 _linalg_inverse
_linalg_makediag _linalg_maketrian _linalg_potrf _linalg_potri
_linalg_slogdet _linalg_sumlogdiag _linalg_syevd _linalg_syrk
_linalg_trmm _linalg_trsm det inverse linalg_det
linalg_extractdiag linalg_extracttrian linalg_gelqf linalg_gemm
linalg_gemm2 linalg_inverse linalg_makediag linalg_maketrian
linalg_potrf linalg_potri linalg_slogdet linalg_sumlogdiag
linalg_syevd linalg_syrk linalg_trmm linalg_trsm slogdet"""),
    "ops/numpy_ops.py": ("A9", """
_np_broadcast_to _np_copy _np_cumsum _np_dot _np_ones_like
_np_prod _np_reshape _np_squeeze _np_sum _np_transpose
_np_zeros_like _npi_arange _npi_argmax _npi_broadcast_to
_npi_concatenate _npi_cumsum _npi_log _npi_ones _npi_reshape
_npi_rtrue_divide_scalar _npi_stack _npi_stack_concat_guard
_npi_sum _npi_tensordot _npi_tensordot_int_axes _npi_true_divide
_npi_true_divide_scalar _npi_uniform _npi_zeros"""),
    "ops/quantization_ops.py": ("A9", """
_contrib_calibrate_entropy _contrib_dequantize _contrib_quantize
_contrib_quantize_v2 _contrib_quantized_act
_contrib_quantized_batch_norm _contrib_quantized_concat
_contrib_quantized_conv _contrib_quantized_elemwise_add
_contrib_quantized_flatten _contrib_quantized_fully_connected
_contrib_quantized_pooling _contrib_requantize"""),
    "ops/vision_ops.py": ("A9", """
Correlation DeformableConvolution DeformablePSROIPooling
MultiBoxDetection MultiBoxPrior MultiBoxTarget MultiProposal
PSROIPooling Proposal _contrib_DeformableConvolution
_contrib_DeformablePSROIPooling _contrib_MultiBoxDetection
_contrib_MultiBoxPrior _contrib_MultiBoxTarget
_contrib_MultiProposal _contrib_PSROIPooling _contrib_Proposal
_contrib_dgl_adjacency
_contrib_dgl_csr_neighbor_non_uniform_sample
_contrib_dgl_csr_neighbor_uniform_sample
_contrib_dgl_graph_compact _contrib_dgl_subgraph
_contrib_edge_id _contrib_getnnz"""),
}

QUEUED = {name: (module, item)
          for module, (item, names) in QUEUED_MODULES.items()
          for name in names.split()}
