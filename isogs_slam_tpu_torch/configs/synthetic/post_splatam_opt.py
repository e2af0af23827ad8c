"""Post-SLAM optimization smoke config: re-optimize the synthetic smoke
run's map against all frames with its estimated trajectory.

A copy of configs/synthetic/post_splatam_opt.py with primary_device="cuda";
every other value is unchanged. The SLAM run it loads is the one
isogs_slam_tpu_torch/configs/synthetic/smoke.py writes.

Run: python -m isogs_slam_tpu_torch.scripts.post_splatam_opt \
         isogs_slam_tpu_torch/configs/synthetic/post_splatam_opt.py \
         [--device cpu]
"""
config = dict(
    workdir="./experiments/Synthetic",
    run_name="synthetic_room_0_postopt",
    seed=0,
    primary_device="cuda",
    scene_radius_depth_ratio=3,
    mean_sq_dist_method="projective",
    gaussian_distribution="isotropic",
    use_wandb=False,
    eval_every=2,
    checkpoint_time_idx=-1,
    capacity_granule=8192,
    raster=dict(max_per_tile=192, isect_per_gaussian=4.0, tile_chunk=80),
    data=dict(
        dataset_name="synthetic",
        basedir="", sequence="synthetic_room",
        param_run_name="synthetic_room_0",   # SLAM run to load
        desired_image_height=120, desired_image_width=160,
        start=0, end=-1, stride=1, num_frames=15,
    ),
    train=dict(
        num_iters_mapping=40,
        sil_thres=0.5,
        loss_weights=dict(im=1.0, depth=1.0),
        lrs_mapping=dict(
            means3D=0.00016, rgb_colors=0.0025, unnorm_rotations=0.001,
            logit_opacities=0.05, log_scales=0.001),
        lrs_mapping_means3D_final=0.0000032,
        lr_delay_mult=0.01,
        use_gaussian_splatting_densification=False,
        chunk_iters=20,
        frames_per_chunk=4,
    ),
)
