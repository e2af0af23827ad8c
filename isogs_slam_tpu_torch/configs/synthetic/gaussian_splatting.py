"""Synthetic-scene offline trainer smoke config (CPU-runnable at this size).

A copy of configs/synthetic/gaussian_splatting.py with
primary_device="cuda"; every other value is unchanged.

Run: python -m isogs_slam_tpu_torch.scripts.gaussian_splatting \
         isogs_slam_tpu_torch/configs/synthetic/gaussian_splatting.py \
         [--device cpu]
"""
config = dict(
    workdir="./experiments/Synthetic_GS",
    run_name="synthetic_room_0",
    seed=0,
    primary_device="cuda",
    scene_radius_depth_ratio=3,
    mean_sq_dist_method="projective",
    gaussian_distribution="isotropic",
    use_wandb=False,
    eval_every=2,
    capacity_granule=8192,
    raster=dict(max_per_tile=192, isect_per_gaussian=4.0, tile_chunk=80),
    data=dict(
        dataset_name="synthetic",
        basedir="", sequence="synthetic_room",
        desired_image_height=120, desired_image_width=160,
        start=0, end=-1, stride=1, num_frames=8,
    ),
    train=dict(
        num_iters_mapping=60,
        sil_thres=0.5,
        add_gaussians_every=2,
        loss_weights=dict(im=1.0, depth=1.0),
        lrs_mapping=dict(
            means3D=0.00016, rgb_colors=0.0025, unnorm_rotations=0.001,
            logit_opacities=0.05, log_scales=0.001),
        lrs_mapping_means3D_final=0.0000032,
        lr_delay_mult=0.01,
        use_gaussian_splatting_densification=True,
        densify_dict=dict(
            start_after=10, remove_big_after=20, stop_after=50,
            densify_every=20, grad_thresh=0.0002, num_to_split_into=2,
            removal_opacity_threshold=0.005,
            final_removal_opacity_threshold=0.005,
            reset_opacities_every=1000),
        chunk_iters=20,
        frames_per_chunk=4,
    ),
)
