"""Tiny sizes of the two configurations for the CPU tests: the same code
paths (config 2 with its dense tail, config 4 all sparse), a few thousand
points."""

TINY = {
    "config2_scannet_2cm": {
        "data": {"voxel_size": [0.1, 0.1, 0.1], "num_points": 3072, "voxel_capacity": 3072,
                 "scene_bounds": [9.6, 9.6, 3.2], "num_workers": 1},
        "model": {"backbone": {"widths": [8, 12, 16, 20, 24], "grid_extent": [96, 96, 32],
                               "capacities": [3072, 2048, 1024, 512, 256]},
                  "rpn": {"hidden": 16, "num_proposals": 8, "pre_nms_topk": 32},
                  "roi": {"grid_size": 3, "hidden": 16, "mask_grid": 6}},
    },
    "config4_semantic_kitti": {
        "data": {"voxel_size": [0.5, 0.5, 0.5], "num_points": 3072, "voxel_capacity": 3072,
                 "num_workers": 1},
        "model": {"backbone": {"widths": [8, 12, 16, 20],
                               "capacities": [3072, 2048, 1024, 512]},
                  "rpn": {"hidden": 16, "num_proposals": 8, "pre_nms_topk": 32},
                  "roi": {"grid_size": 3, "hidden": 16, "mask_grid": 6}},
    },
}
