"""Full-resolution synthetic validation config (680x1200).

A copy of isogs_slam_tpu/configs/synthetic/full_res.py with
primary_device="cuda"; every other value is unchanged.

The toy smoke config cannot exercise per-tile saturation, the bf16
gradient scatter at scale, or the isect-capacity headroom; this config
replays the bench workload (replica-parity sizes and iteration counts)
as a REAL SLAM run with evaluation, so quality at bench scale is
measurable without Replica data on disk.

Run: python -m isogs_slam_tpu_torch.scripts.splatam \
         isogs_slam_tpu_torch/configs/synthetic/full_res.py --end-at 30
"""

scene_name = "synthetic_room_fullres"
seed = 0

config = dict(
    workdir="./experiments/Synthetic",
    run_name=f"{scene_name}_{seed}",
    seed=seed,
    primary_device="cuda",
    map_every=5,
    keyframe_every=5,
    mapping_window_size=24,
    # every 5: the [progress] ATE-so-far line is the drift-shape signal
    # (rising = gauge drift / map-error absorption, flat = tracker noise)
    # — one cheap render per report
    report_global_progress_every=5,
    eval_every=5,
    scene_radius_depth_ratio=3,
    mean_sq_dist_method="projective",
    gaussian_distribution="isotropic",
    report_iter_progress=False,
    load_checkpoint=False,
    checkpoint_time_idx=0,
    save_checkpoints=False,
    checkpoint_interval=100,
    use_wandb=False,
    compact_every=50,
    capacity_granule=65536,
    raster=dict(max_per_tile=512, isect_per_gaussian=2.5, tile_chunk=256),
    isogs=dict(sample_size=8192, k=16, target_saturation=1.0,
               knn_block=8192),
    data=dict(
        dataset_name="synthetic",
        basedir="",
        sequence=scene_name,
        # Replica-like pixel motion (~3 px/frame at fx=900): photometric
        # tracking needs inter-frame motion inside the ~2-3 px loss basin
        # (see datasets/synthetic.py traj_step note)
        synthetic_traj_step=0.004,
        desired_image_height=680,
        desired_image_width=1200,
        start=0,
        end=-1,
        stride=1,
        num_frames=40,
    ),
    tracking=dict(
        use_gt_poses=False,
        forward_prop=True,
        # the synthetic orbit moves ~10-15 px/frame — harsher than
        # Replica (~5 px at fx=600); per the reference's own per-dataset
        # pattern (TUM: 200 iters vs Replica: 10) tracking gets more
        # iterations + lr here
        num_iters=40,
        # anneal the pose-optimizer bounce (see TrackingConfig.lr_decay)
        lr_decay=0.92,
        # point-to-plane ICP GN polish after the Adam loop (slam/icp.py).
        # MEASURED OFF (2026-08-18 ablation, 30 frames): gn_iters=3 alone
        # drove ATE to 73.4 cm (guard acceptance 0.97 — it accepts steps
        # that wreck the trajectory), while pyramid-only reached 1.22 cm.
        # Keep 0 until the guard failure is understood (see NOTES.md).
        gn_iters=0,
        # coarse-to-fine: one 2x-downsampled pass widens the photometric
        # basin for this trajectory's ~10-15 px/frame motion. MEASURED
        # (2026-08-18, 30 frames): pyramid-only ATE 1.22 cm vs 1.90 cm
        # without — breaks the round-1 2.66 cm floor.
        pyramid_levels=2,
        pyramid_iters=15,
        use_sil_for_loss=True,
        # single-sheet synthetic walls: the iso density target pulls the
        # rendered silhouette toward ~0.9, so a 0.9 threshold leaves the
        # mask half-open and hovering at the decision boundary; 0.5 keeps
        # the masked-tracking path exercised with stable coverage
        sil_thres=0.5,
        use_l1=True,
        ignore_outlier_depth_loss=False,
        loss_weights=dict(im=0.5, depth=1.0),
        lrs=dict(means3D=0.0, rgb_colors=0.0, unnorm_rotations=0.0,
                 logit_opacities=0.0, log_scales=0.0,
                 cam_unnorm_rots=0.001, cam_trans=0.004),
    ),
    mapping=dict(
        num_iters=40,
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
             visualize_cams=True, viz_w=600, viz_h=340, viz_near=0.01,
             viz_far=100.0, view_scale=2, viz_fps=5,
             enter_interactive_post_online=False),
)
