"""Post-SLAM optimization at full width (680x1200): re-optimize the map of
a run of isogs_slam_tpu_torch/configs/synthetic/full_res.py against its
estimated trajectory (the reference's scripts/post_splatam_opt.py
workflow).

A copy of configs/synthetic/post_splatam_opt_fullres.py with
primary_device="cuda", the SLAM run it loads set to full_res.py's run
directory (data.param_run_name; override it, or data.param_ckpt_path, to
point at another checkpoint), and num_frames set to full_res.py's. The data
block must replicate full_res.py's generator inputs (dataset, seed,
synthetic_traj_step, image size) so the frames are the SLAM run's frames;
the synthetic trajectory does not depend on num_frames, and the
checkpoint's frame clamps the trajectory anyway.

Run: python -m isogs_slam_tpu_torch.scripts.post_splatam_opt \
         isogs_slam_tpu_torch/configs/synthetic/post_splatam_opt_fullres.py
"""
config = dict(
    workdir="./experiments/Synthetic",
    run_name="synthetic_room_fullres_0_postopt",
    seed=0,
    primary_device="cuda",
    scene_radius_depth_ratio=3,
    mean_sq_dist_method="projective",
    gaussian_distribution="isotropic",
    use_wandb=False,
    eval_every=5,
    checkpoint_time_idx=-1,
    capacity_granule=65536,
    raster=dict(max_per_tile=512, isect_per_gaussian=2.5, tile_chunk=256),
    data=dict(
        dataset_name="synthetic",
        basedir="", sequence="synthetic_room_fullres_postopt",
        param_run_name="synthetic_room_fullres_0",   # SLAM run to load
        synthetic_traj_step=0.004,            # MUST match full_res.py
        desired_image_height=680, desired_image_width=1200,
        start=0, end=-1, stride=1, num_frames=40,
    ),
    train=dict(
        num_iters_mapping=400,
        sil_thres=0.5,
        loss_weights=dict(im=1.0, depth=1.0),
        lrs_mapping=dict(
            means3D=0.00016, rgb_colors=0.0025, unnorm_rotations=0.001,
            logit_opacities=0.05, log_scales=0.001),
        lrs_mapping_means3D_final=0.0000032,
        lr_delay_mult=0.01,
        use_gaussian_splatting_densification=False,
        chunk_iters=40,
        frames_per_chunk=4,
    ),
)
