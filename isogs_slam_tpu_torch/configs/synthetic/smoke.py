"""Synthetic-scene smoke config: small end-to-end SLAM, runnable on the CPU
with `--device cpu`.

A copy of isogs_slam_tpu/configs/synthetic/smoke.py with
primary_device="cuda"; every other value is unchanged.
"""

scene_name = "synthetic_room"
seed = 0

map_every = 5
keyframe_every = 5
mapping_window_size = 10
tracking_iters = 12
mapping_iters = 20

config = dict(
    workdir="./experiments/Synthetic",
    run_name=f"{scene_name}_{seed}",
    seed=seed,
    primary_device="cuda",
    map_every=map_every,
    keyframe_every=keyframe_every,
    mapping_window_size=mapping_window_size,
    report_global_progress_every=3,
    eval_every=2,
    scene_radius_depth_ratio=3,
    mean_sq_dist_method="projective",
    gaussian_distribution="isotropic",
    report_iter_progress=False,
    load_checkpoint=False,
    checkpoint_time_idx=0,
    save_checkpoints=True,
    checkpoint_interval=10,
    use_wandb=False,
    compact_every=50,
    capacity_granule=8192,
    # max_per_tile must exceed the per-tile Gaussian density: per-pixel
    # init puts ~256/tile + margin (overflow silently truncates content)
    raster=dict(max_per_tile=512, isect_per_gaussian=6.0, tile_chunk=80),
    isogs=dict(sample_size=1024, k=16, target_saturation=1.0,
               knn_block=4096),
    data=dict(
        dataset_name="synthetic",
        basedir="",
        sequence=scene_name,
        desired_image_height=120,
        desired_image_width=160,
        start=0,
        end=-1,
        stride=1,
        num_frames=15,
    ),
    tracking=dict(
        use_gt_poses=False,
        forward_prop=True,
        num_iters=tracking_iters,
        use_sil_for_loss=True,
        # the synthetic wall is a single Gaussian sheet: after the IsoGS
        # density target pulls opacities down, silhouette tops out ~0.98,
        # so the reference's 0.99 threshold would empty the tracking mask
        sil_thres=0.90,
        use_l1=True,
        ignore_outlier_depth_loss=False,
        loss_weights=dict(im=0.5, depth=1.0),
        lrs=dict(means3D=0.0, rgb_colors=0.0, unnorm_rotations=0.0,
                 logit_opacities=0.0, log_scales=0.0,
                 cam_unnorm_rots=0.002, cam_trans=0.01),
    ),
    mapping=dict(
        num_iters=mapping_iters,
        add_new_gaussians=True,
        sil_thres=0.5,
        use_l1=True,
        use_sil_for_loss=False,
        ignore_outlier_depth_loss=False,
        loss_weights=dict(im=0.5, depth=1.0, flat=50.0, iso=2.0),
        lrs=dict(means3D=0.0001, rgb_colors=0.0025, unnorm_rotations=0.001,
                 logit_opacities=0.05, log_scales=0.001,
                 cam_unnorm_rots=0.0, cam_trans=0.0),
        prune_gaussians=True,
        pruning_dict=dict(
            start_after=0, remove_big_after=0, stop_after=20, prune_every=20,
            removal_opacity_threshold=0.005,
            final_removal_opacity_threshold=0.005,
            reset_opacities=False, reset_opacities_every=500),
        use_gaussian_splatting_densification=False,
        densify_dict=dict(
            start_after=500, remove_big_after=3000, stop_after=5000,
            densify_every=100, grad_thresh=0.0002, num_to_split_into=2,
            removal_opacity_threshold=0.005,
            final_removal_opacity_threshold=0.005,
            reset_opacities_every=3000),
    ),
    viz=dict(render_mode="color", offset_first_viz_cam=True, show_sil=False,
             visualize_cams=True, viz_w=160, viz_h=120, viz_near=0.01,
             viz_far=100.0, view_scale=2, viz_fps=5,
             enter_interactive_post_online=False),
)
