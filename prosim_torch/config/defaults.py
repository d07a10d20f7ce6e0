"""Default configuration tree.

Mirrors the key surface of the reference config so experiment yamls carry over
(reference: prosim/config/default.py:16-733). Keys that only make sense for
the torch runtime (wandb paths, cluster profiles) are kept minimal.
"""

from prosim_torch.config.node import CfgNode as CN


def get_default_config() -> CN:
    _C = CN()

    _C.DEBUG = False
    _C.SEED = 0
    _C.SAVE_CHECKPOINT = True
    _C.SAVE_DIR = "results"
    _C.EXPERIMENT_DIR = "results/default"
    _C.EXPERIMENT_NAME = "default"
    _C.WANDB_PROJ = "prosim_tpu"

    _C.LOAD_CHECKPOINT_MODEL = False
    _C.LOAD_CHECKPOINT_TRAINER = False
    _C.LOAD_CHECKPOINT_PATH = None
    # Steps between periodic "last" checkpoint saves (reference saves
    # save_last every epoch via Lightning ModelCheckpoint, trainer.py:248-256).
    _C.CHECKPOINT_INTERVAL = 500

    _C.MAX_EPOCHES = 1
    _C.LIMIT_TRAIN_BATCHES = 1.0
    _C.VAL_INTERVAL = 1
    _C.ENABLE_VIS = False
    _C.VIS_INTERVAL = 400

    # ------------------------------------------------------------------ train
    _C.TRAIN = CN()
    _C.TRAIN.BATCH_SIZE = 16
    _C.TRAIN.NUM_WORKERS = 4
    _C.TRAIN.LR = 1e-4
    _C.TRAIN.OPTIMIZER = "adamw"
    _C.TRAIN.WEIGHT_DECAY = 0.01
    _C.TRAIN.GRAD_CLIP = 0.5
    # rematerialization policy for the train-mode forward: 'full' recomputes
    # everything in backward (lowest memory), 'dots' saves matmul outputs and
    # recomputes elementwise ops, 'none' stores all activations. Measured on
    # v5e at the demo arch, batch 16: full 9.2 train scenes/s, dots 6.5
    # (HBM pressure), none OOMs - keep 'full'.
    _C.TRAIN.REMAT_POLICY = "full"
    _C.TRAIN.SCHEDULER = CN()
    _C.TRAIN.SCHEDULER.TYPE = "LinearWarmupCosineAnnealingLR"
    _C.TRAIN.SCHEDULER.WARMUP_STEPS = 2500
    _C.TRAIN.SCHEDULER.MAX_STEPS = 228270
    _C.TRAIN.SCHEDULER.ETA_MIN = 0.0

    _C.VAL = CN()
    _C.VAL.BATCH_SIZE = 16
    _C.VAL.NUM_WORKERS = 4
    _C.VAL.SHUFFLE = False

    _C.TEST = CN()
    _C.TEST.BATCH_SIZE = 16
    _C.TEST.NUM_WORKERS = 4
    _C.TEST.SHUFFLE = False

    # ---------------------------------------------------------------- rollout
    _C.ROLLOUT = CN()
    _C.ROLLOUT.ENABLE = False
    _C.ROLLOUT.MODE = "batched"
    _C.ROLLOUT.NUM_WORKERS = 1
    _C.ROLLOUT.INTERVAL_EPOCH = 1
    _C.ROLLOUT.WARMUP_EPOCH = 0
    _C.ROLLOUT.CONTROL_NUM = 1
    _C.ROLLOUT.SAMPLE_NUM = 32  # M replicas for WOSAC
    # cap on scenes-per-compiled-rollout (B_chunk * M): one v5e chip fits
    # 64 tiled demo-arch scenes with rollout metrics on top; the validation
    # rollout callback chunks its batch to stay under this
    _C.ROLLOUT.MAX_TILE = 64
    # external-farm rollout requests during training (reference:
    # rollout/callbacks.py:314-400 rollout_callback_distributed)
    _C.ROLLOUT.REQUEST_METRIC = False
    _C.ROLLOUT.ONLINE_M = 1
    _C.ROLLOUT_REQUEST_PATH = ""

    _C.ROLLOUT.POLICY = CN()
    _C.ROLLOUT.POLICY.REPLAN_FREQ = 10
    _C.ROLLOUT.POLICY.POLICY_FREQ = 80
    _C.ROLLOUT.POLICY.MAX_STEPS = 80
    _C.ROLLOUT.POLICY.POLICY_START_FRAME = 10
    _C.ROLLOUT.POLICY.TOP_K = 1
    _C.ROLLOUT.POLICY.TOP_K_TRAIN = 1

    # ------------------------------------------------------------------- task
    _C.TASK = CN()
    _C.TASK.TYPES = ["motion_pred"]
    _C.TASK.MOTION_PRED = CN()
    _C.TASK.MOTION_PRED.WEIGHT = 1.0
    _C.TASK.MOTION_PRED.LOSS = "paired_mse_k"
    _C.TASK.MOTION_PRED.METRICS = ["pair_traj_pred"]
    _C.TASK.MOTION_PRED.PROMPT = "agent_status"

    # ----------------------------------------------------------------- prompt
    _C.PROMPT = CN()
    _C.PROMPT.AGENT_STATUS = CN()
    _C.PROMPT.AGENT_STATUS.USE_VEL = True
    _C.PROMPT.AGENT_STATUS.USE_EXTEND = True
    _C.PROMPT.AGENT_STATUS.USE_AGENT_TYPE = True

    _C.PROMPT.CONDITION = CN()
    _C.PROMPT.CONDITION.TYPES = []
    _C.PROMPT.CONDITION.SAMPLE_MODE = CN()
    _C.PROMPT.CONDITION.SAMPLE_MODE.TRAIN = "none"
    _C.PROMPT.CONDITION.SAMPLE_MODE.VAL = "none"
    _C.PROMPT.CONDITION.SAMPLE_RATE = 1.0
    _C.PROMPT.CONDITION.RANDOM_SAMPLE = CN()
    _C.PROMPT.CONDITION.RANDOM_SAMPLE.TRAIN = True
    _C.PROMPT.CONDITION.RANDOM_SAMPLE.VAL = False
    _C.PROMPT.CONDITION.MAX_COND_PER_SCENE = 128
    _C.PROMPT.CONDITION.USE_PRIORITY_MASK = False
    # evaluate under several prompting regimes, one eval pass per named yaml
    # in configs/cond_sampler/ (reference: config/default.py:339,
    # trainer.py:198-206)
    _C.PROMPT.CONDITION.EVAL_COND_SETS = []
    _C.PROMPT.CONDITION.SAMPLE_BEFORE_PRIORITY = True
    _C.PROMPT.CONDITION.USE_SOFT_PRIORITY = False
    # highest priority first (reference: config/default.py:344-349), extended
    # with the extra types this framework generates
    _C.PROMPT.CONDITION.PRIORITY_ORDER = [
        "llm_text_OneText", "motion_tag_OneText", "goal_OneText",
        "v2v_tag", "v_action_tag", "goal", "drag_point",
    ]
    _C.PROMPT.CONDITION.PRIORITY_SCORES = CN()
    _C.PROMPT.CONDITION.PRIORITY_SCORES.llm_text_OneText = 50.0
    _C.PROMPT.CONDITION.PRIORITY_SCORES.motion_tag_OneText = 50.0
    _C.PROMPT.CONDITION.PRIORITY_SCORES.goal_OneText = 50.0
    _C.PROMPT.CONDITION.PRIORITY_SCORES.v2v_tag = 10.0
    _C.PROMPT.CONDITION.PRIORITY_SCORES.v_action_tag = 10.0
    _C.PROMPT.CONDITION.PRIORITY_SCORES.goal = 5.0
    _C.PROMPT.CONDITION.PRIORITY_SCORES.drag_point = 1.0
    _C.PROMPT.CONDITION.OneText = CN()
    _C.PROMPT.CONDITION.OneText.USE_PLACEHOLDER = False
    _C.PROMPT.CONDITION.OneText.SHUFFLE_TEXT = False

    _C.PROMPT.CONDITION.MOTION_TAG = CN()
    _C.PROMPT.CONDITION.MOTION_TAG.USED_TAGS = [
        "Accelerate", "Decelerate", "KeepSpeed", "Stopping",
        "LeftLaneChange", "RightLaneChange", "KeepLane",
        "LeftTurn", "RightTurn", "Straight", "Parked",
    ]
    _C.PROMPT.CONDITION.MOTION_TAG.USE_PROCESSING = True
    _C.PROMPT.CONDITION.MOTION_TAG.INTEGRATE_TOLERANCE = 10
    _C.PROMPT.CONDITION.MOTION_TAG.MIN_DURATION = 10

    _C.PROMPT.CONDITION.DRAG_POINT = CN()
    _C.PROMPT.CONDITION.DRAG_POINT.SAMPLE_RATE = 10
    _C.PROMPT.CONDITION.DRAG_POINT.NOISE_STD = 1.0
    _C.PROMPT.CONDITION.DRAG_POINT.MAX_POINTS = 8

    # released prosim_instruct_520k texts (reference: data_utils.py:57-72,
    # 626-642): per-split folder of {id%100}/{scene_id}_10_90_output.txt and
    # the ego-(x,y)@t0 -> scene-id pickles. Empty = fall back to templated
    # tag texts.
    _C.PROMPT.CONDITION.LLM_TEXT = CN()
    _C.PROMPT.CONDITION.LLM_TEXT.FOLDER = CN()
    _C.PROMPT.CONDITION.LLM_TEXT.FOLDER.TRAIN = ""
    _C.PROMPT.CONDITION.LLM_TEXT.FOLDER.VAL = ""
    _C.PROMPT.CONDITION.LLM_TEXT.IDS_PKL = CN()
    _C.PROMPT.CONDITION.LLM_TEXT.IDS_PKL.TRAIN = ""
    _C.PROMPT.CONDITION.LLM_TEXT.IDS_PKL.VAL = ""

    # ------------------------------------------------------------------- loss
    _C.LOSS = CN()
    _C.LOSS.USE_CLS_TRAJ = True
    _C.LOSS.USE_PED_CYCLIST = True
    _C.LOSS.GOAL_WEIGHT = 0.0

    _C.LOSS.STEP_TRAJ = CN()
    _C.LOSS.STEP_TRAJ.POS_WEIGHT = 0.0
    _C.LOSS.STEP_TRAJ.CLS_WEIGHT = 0.0
    _C.LOSS.STEP_TRAJ.HEAD_WEIGHT = 0.0
    _C.LOSS.STEP_TRAJ.VEL_WEIGHT = 0.0

    _C.LOSS.ROLLOUT_TRAJ = CN()
    _C.LOSS.ROLLOUT_TRAJ.ENABLE = True
    _C.LOSS.ROLLOUT_TRAJ.WEIGHT = 1.0
    _C.LOSS.ROLLOUT_TRAJ.VEL_WEIGHT = 10.0
    _C.LOSS.ROLLOUT_TRAJ.HEAD_WEIGHT = 10.0
    _C.LOSS.ROLLOUT_TRAJ.USE_OFFROAD_LOSS = False
    _C.LOSS.ROLLOUT_TRAJ.OFFROAD_WEIGHT = 1.0
    _C.LOSS.ROLLOUT_TRAJ.OFFROAD_T_SAMPLE_RATE = 10
    _C.LOSS.ROLLOUT_TRAJ.OFFROAD_TGT_MODE = "pred"
    _C.LOSS.ROLLOUT_TRAJ.OFFROAD_MARGIN = 3.0
    _C.LOSS.ROLLOUT_TRAJ.USE_COLLISION_LOSS = False
    _C.LOSS.ROLLOUT_TRAJ.COLLISION_WEIGHT = 1.0
    _C.LOSS.ROLLOUT_TRAJ.COLLISION_T_SAMPLE_RATE = 10
    _C.LOSS.ROLLOUT_TRAJ.COLLISION_TGT_MODE = "pred"
    _C.LOSS.ROLLOUT_TRAJ.COLLISION_K = 4
    _C.LOSS.ROLLOUT_TRAJ.COLLISION_THRESHOLD = 0.0
    _C.LOSS.ROLLOUT_TRAJ.COLLISION_VEHICLE_ONLY = True
    _C.LOSS.ROLLOUT_TRAJ.USE_GOAL_PRED_LOSS = False
    _C.LOSS.ROLLOUT_TRAJ.GOAL_MODEL_LR_SCALE = 0.0
    _C.LOSS.ROLLOUT_TRAJ.GOAL_PRED_LOSS_COND_MASK = False
    _C.LOSS.ROLLOUT_TRAJ.GOAL_WEIGHT = 0.0
    _C.LOSS.ROLLOUT_TRAJ.USE_PROMPT_LOSS = False
    _C.LOSS.ROLLOUT_TRAJ.PROMPT_WEIGHT = 1000.0

    _C.LOSS.GOAL_DIST_PRED = CN()
    _C.LOSS.GOAL_DIST_PRED.ENABLE = False
    _C.LOSS.GOAL_DIST_PRED.WEIGHT = 1.0
    # reference default.py:410-411: CE toward the nearest hypothesis is
    # weighted 10x against the point huber; the spread regularizer is off
    _C.LOSS.GOAL_DIST_PRED.CLS_WEIGHT = 10.0
    _C.LOSS.GOAL_DIST_PRED.VAR_WEIGHT = 0.0

    _C.LOSS.TRAJ_CRITERION = CN()
    _C.LOSS.TRAJ_CRITERION.TYPE = "huber"
    _C.LOSS.TRAJ_CRITERION.HUBER_DELTA = 1.0

    # ---------------------------------------------------------------- dataset
    _C.DATASET = CN()
    _C.DATASET.TYPE = "prosim_imitation"
    _C.DATASET.CACHE_MAP = False
    _C.DATASET.USE_WAYMO_ROAD_EDGE = False
    _C.DATASET.USE_RASTER_MAP = False
    _C.DATASET.USE_MOTION_TAGS = False
    _C.DATASET.USE_ALL_AGENTS = False
    _C.DATASET.USE_PED_CYCLIST = True

    _C.DATASET.DATA_PATHS = CN()
    _C.DATASET.DATA_PATHS.CACHE_DIR = ""
    _C.DATASET.DATA_PATHS.VECTOR_LANE_CACHE = ""
    _C.DATASET.DATA_PATHS.MOTION_TAGS = CN()
    _C.DATASET.DATA_PATHS.MOTION_TAGS.TRAIN = ""
    _C.DATASET.DATA_PATHS.MOTION_TAGS.VAL = ""

    _C.DATASET.MAP = CN()
    _C.DATASET.MAP.COLLATE_MODE = "lane"
    _C.DATASET.MAP.CENTER_SAMPLE_RATE = 1
    _C.DATASET.MAP.EDGE_SAMPLE_RATE = 4
    _C.DATASET.MAP.MAX_LANE_POINTS = 20
    _C.DATASET.MAP.INCLUDE_TYPES = ["center", "right_edge", "left_edge"]
    _C.DATASET.MAP.RANGE = CN()
    _C.DATASET.MAP.RANGE.TRAIN = 200
    _C.DATASET.MAP.RANGE.VAL = 200
    _C.DATASET.MAP.RANGE.TEST = 200
    _C.DATASET.MAP.RANGE.ROLLOUT = 200

    _C.DATASET.AGENT = CN()
    _C.DATASET.AGENT.USE_SAMPLE = CN()
    _C.DATASET.AGENT.USE_SAMPLE.TRAIN = True
    _C.DATASET.AGENT.USE_SAMPLE.VAL = True
    _C.DATASET.AGENT.USE_SAMPLE.TEST = True
    _C.DATASET.AGENT.SAMPLE_MODE = "scene"
    _C.DATASET.AGENT.SCENE_MAX_AGENT = 128
    _C.DATASET.AGENT.BATCH_MAX_AGENT = 3000
    _C.DATASET.AGENT.SCENE_MIN_AGENT_SAMPLE = 16
    _C.DATASET.AGENT.RANDOM_TRAIN_SAMPLE = True
    _C.DATASET.AGENT.RANDOM_VAL_SAMPLE = False
    _C.DATASET.AGENT.EGO_ONLY = CN()
    _C.DATASET.AGENT.EGO_ONLY.TRAIN = False
    _C.DATASET.AGENT.EGO_ONLY.VAL = False
    _C.DATASET.AGENT.EGO_ONLY.TEST = False
    _C.DATASET.AGENT.EGO_ONLY.ROLLOUT = False

    _C.DATASET.SOURCE = CN()
    _C.DATASET.SOURCE.TRAIN = ["waymo_train"]
    _C.DATASET.SOURCE.VAL = ["waymo_val"]
    _C.DATASET.SOURCE.TEST = ["waymo_val"]
    _C.DATASET.SOURCE.ROLLOUT = ["waymo_val"]

    _C.DATASET.DATA_LIST = CN()
    _C.DATASET.DATA_LIST.MODE = "all"
    _C.DATASET.DATA_LIST.TRAIN = ""
    _C.DATASET.DATA_LIST.VAL = ""
    _C.DATASET.DATA_LIST.TEST = ""
    _C.DATASET.DATA_LIST.ROLLOUT = ""

    _C.DATASET.SCENE = CN()
    _C.DATASET.SCENE.SAMPLE_RATE = CN()
    _C.DATASET.SCENE.SAMPLE_RATE.TRAIN = 1
    _C.DATASET.SCENE.SAMPLE_RATE.VAL = 1
    _C.DATASET.SCENE.SAMPLE_RATE.TEST = 1
    _C.DATASET.SCENE.SAMPLE_RATE.ROLLOUT = 1

    _C.DATASET.USE_EGO_CENTER = CN()
    _C.DATASET.USE_EGO_CENTER.TRAIN = True
    _C.DATASET.USE_EGO_CENTER.VAL = True
    _C.DATASET.USE_EGO_CENTER.TEST = True

    _C.DATASET.MOTION = CN()
    _C.DATASET.MOTION.DT = 0.1
    _C.DATASET.MOTION.HISTORY_SEC = 1.0
    _C.DATASET.MOTION.FUTURE_SEC = CN()
    _C.DATASET.MOTION.FUTURE_SEC.TRAIN = 8.0
    _C.DATASET.MOTION.FUTURE_SEC.VAL = 8.0
    _C.DATASET.MOTION.FUTURE_SEC.TEST = 8.0
    _C.DATASET.MOTION.FUTURE_SEC.ROLLOUT = 8.0

    _C.DATASET.FORMAT = CN()
    _C.DATASET.FORMAT.TYPES = CN()
    _C.DATASET.FORMAT.TYPES.INIT_MAP = "center_vec"
    _C.DATASET.FORMAT.TYPES.INIT_OBS = "center_history"
    _C.DATASET.FORMAT.TYPES.IO_PAIR = "local_T_step"

    _C.DATASET.FORMAT.MAP = CN()
    _C.DATASET.FORMAT.MAP.LOCAL_RANGE = 200
    _C.DATASET.FORMAT.MAP.MAX_POINTS = 2048
    _C.DATASET.FORMAT.MAP.WITH_TYPE_EMB = True
    _C.DATASET.FORMAT.MAP.WITH_DIR = True
    # bug-for-bug parity with the reference map crop: when more polylines are
    # in range than MAX_POINTS, the reference computes the point mask from the
    # PRE-sort chunk order while the vectors get distance-sorted
    # (reference: format_utils.py:168-178); checkpoints trained there saw the
    # stale masks. Off = geometrically consistent masks.
    _C.DATASET.FORMAT.MAP.REFERENCE_UNSORTED_MASK_QUIRK = False

    _C.DATASET.FORMAT.TARGET = CN()
    _C.DATASET.FORMAT.TARGET.SAMPLE_RATE = 10
    _C.DATASET.FORMAT.TARGET.STEPS = 10
    _C.DATASET.FORMAT.TARGET.ELEMENTS = "x,y,h"
    _C.DATASET.FORMAT.TARGET.TAIL_PADDING = True

    _C.DATASET.FORMAT.HISTORY = CN()
    _C.DATASET.FORMAT.HISTORY.ELEMENTS = "x,y,s,c,xd,yd,xdd,ydd"
    _C.DATASET.FORMAT.HISTORY.STEPS = 11
    _C.DATASET.FORMAT.HISTORY.WITH_EXTEND = True
    _C.DATASET.FORMAT.HISTORY.WITH_AGENT_TYPE = True
    _C.DATASET.FORMAT.HISTORY.WITH_TIME_EMB = True

    _C.DATASET.FORMAT.GOAL = CN()
    _C.DATASET.FORMAT.GOAL.LOCAL = True
    _C.DATASET.FORMAT.GOAL.ELEMENTS = "x,y"

    _C.DATASET.FORMAT.SYM_COORD = CN()
    _C.DATASET.FORMAT.SYM_COORD.MAP = True
    _C.DATASET.FORMAT.SYM_COORD.OBS = True

    _C.DATASET.FORMAT.FUTURE_OBS_TYPE = "latest"
    _C.DATASET.FORMAT.FUTURE_OBS_UPDATE_CENTER = True

    # static padding sizes (TPU-first: every batch is padded to these)
    _C.DATASET.FORMAT.PAD = CN()
    _C.DATASET.FORMAT.PAD.NUM_AGENTS = 128      # policy (target) agent slots
    _C.DATASET.FORMAT.PAD.NUM_OBS_AGENTS = 160  # all-agent observation slots
    _C.DATASET.FORMAT.PAD.NUM_LANES = 2048      # map polyline slots
    _C.DATASET.FORMAT.PAD.NUM_CONDS = 32        # per-type condition slots

    # ------------------------------------------------------------------ model
    _C.MODEL = CN()
    _C.MODEL.HIDDEN_DIM = 128
    _C.MODEL.REL_POS_EDGE_FUNC = "radius"
    _C.MODEL.TYPE = "prosim_policy_relpe_T_step_temporal_close_loop"
    _C.MODEL.BPTT = False
    _C.MODEL.PARITY = CN()
    # bug-for-bug reproduction of the reference rollout frame quirk: the
    # reference adds un-rotated agent-frame traj offsets to the scene-frame
    # init position when rebuilding agent poses during rollout
    # (reference: traj_sam.py:211-214), rotating only in the final world
    # conversion (gpu_utils.py:260). Checkpoints trained there expect the
    # quirk; default False keeps the geometrically consistent frame.
    _C.MODEL.PARITY.REFERENCE_STEP_ENV_FRAME = False
    _C.MODEL.DTYPE = "float32"  # compute dtype for the network body

    _C.MODEL.OBS_UPDATE = CN()
    _C.MODEL.OBS_UPDATE.ATTN_UPDATE = False
    _C.MODEL.OBS_UPDATE.FUSION = "replace"

    _C.MODEL.MAP_ENCODER = CN()
    _C.MODEL.MAP_ENCODER.MLP = CN()
    _C.MODEL.MAP_ENCODER.MLP.POOL = "max"
    _C.MODEL.MAP_ENCODER.POINTNET = CN()
    _C.MODEL.MAP_ENCODER.POINTNET.NUM_PRE_LAYERS = 3
    _C.MODEL.MAP_ENCODER.POINTNET.NUM_MLP_LAYERS = 5

    _C.MODEL.OBS_ENCODER = CN()
    _C.MODEL.OBS_ENCODER.MLP = CN()
    _C.MODEL.OBS_ENCODER.MLP.POOL = "max"
    _C.MODEL.OBS_ENCODER.POINTNET = CN()
    _C.MODEL.OBS_ENCODER.POINTNET.NUM_PRE_LAYERS = 1
    _C.MODEL.OBS_ENCODER.POINTNET.NUM_MLP_LAYERS = 3

    _C.MODEL.SCENE_ENCODER = CN()
    _C.MODEL.SCENE_ENCODER.TYPE = "attn_fusion_relpe"
    _C.MODEL.SCENE_ENCODER.MAP_TYPE = "pointnet"
    _C.MODEL.SCENE_ENCODER.OBS_TYPE = "pointnet"
    _C.MODEL.SCENE_ENCODER.ATTN = CN()
    _C.MODEL.SCENE_ENCODER.ATTN.LEARNABLE_PE = False
    _C.MODEL.SCENE_ENCODER.ATTN.PE_NUM_FREQ = 64
    _C.MODEL.SCENE_ENCODER.ATTN.NUM_LAYER = 6
    _C.MODEL.SCENE_ENCODER.ATTN.NUM_HEAD = 8
    _C.MODEL.SCENE_ENCODER.ATTN.FF_DIM = 16  # head_dim (QCNet naming quirk kept)
    _C.MODEL.SCENE_ENCODER.ATTN.DROPOUT = 0.1
    _C.MODEL.SCENE_ENCODER.ATTN.MAX_NUM_NEIGH = 32
    _C.MODEL.SCENE_ENCODER.ATTN.AGENT_RADIUS = 100
    _C.MODEL.SCENE_ENCODER.ATTN.SCENE_RADIUS = 50

    _C.MODEL.DECODER = CN()
    _C.MODEL.DECODER.TYPE = "attn_fusion_relpe"
    _C.MODEL.DECODER.HIDDEN_DIM = 128  # filled from MODEL.HIDDEN_DIM in fixup
    _C.MODEL.DECODER.REL_POS_EDGE_FUNC = "radius"
    _C.MODEL.DECODER.GOAL_PRED = CN()
    _C.MODEL.DECODER.GOAL_PRED.ENABLE = False
    _C.MODEL.DECODER.GOAL_PRED.K = 32
    _C.MODEL.DECODER.GOAL_PRED.PRED_DIM = 2
    _C.MODEL.DECODER.ATTN = CN()
    _C.MODEL.DECODER.ATTN.PROMPT_CENTER = True
    _C.MODEL.DECODER.ATTN.LEARNABLE_PE = False
    _C.MODEL.DECODER.ATTN.PE_NUM_FREQ = 64
    _C.MODEL.DECODER.ATTN.NUM_LAYER = 6
    _C.MODEL.DECODER.ATTN.NUM_HEAD = 8
    _C.MODEL.DECODER.ATTN.FF_DIM = 16
    _C.MODEL.DECODER.ATTN.DROPOUT = 0.1
    _C.MODEL.DECODER.ATTN.SCENE_RADIUS = 300
    _C.MODEL.DECODER.ATTN.PROMPT_RADIUS = 300
    _C.MODEL.DECODER.ATTN.MAX_NUM_NEIGH = 512

    _C.MODEL.POLICY = CN()
    _C.MODEL.POLICY.TYPE = "rel_pe_temporal"
    _C.MODEL.POLICY.ACT_DECODER = CN()
    _C.MODEL.POLICY.ACT_DECODER.TYPE = "policy_no_rnn"
    _C.MODEL.POLICY.ACT_DECODER.RANDOM_NOISE_STD = 0.0
    _C.MODEL.POLICY.ACT_DECODER.TRAJ = CN()
    _C.MODEL.POLICY.ACT_DECODER.TRAJ.K = 1
    _C.MODEL.POLICY.ACT_DECODER.TRAJ.PRED_GMM = False
    _C.MODEL.POLICY.ACT_DECODER.TRAJ.PRED_VEL = True
    _C.MODEL.POLICY.ACT_DECODER.TRAJ.PRED_MODE = "anchor"
    _C.MODEL.POLICY.ACT_DECODER.TRAJ.CLUSTER_PATH = ""
    _C.MODEL.POLICY.ACT_DECODER.CONTEXT = CN()
    _C.MODEL.POLICY.ACT_DECODER.CONTEXT.GOAL = False
    _C.MODEL.POLICY.ACT_DECODER.CONTEXT.EMD = True
    _C.MODEL.POLICY.ACT_DECODER.CONTEXT.GT_GOAL = False
    _C.MODEL.POLICY.ACT_DECODER.CONTEXT.USE_POSE_EMB = False
    _C.MODEL.POLICY.ACT_DECODER.MCG = CN()
    _C.MODEL.POLICY.ACT_DECODER.MCG.LAYER = 3
    _C.MODEL.POLICY.ACT_DECODER.ATTN = CN()
    _C.MODEL.POLICY.ACT_DECODER.ATTN.POLICY_CENTER = True
    _C.MODEL.POLICY.ACT_DECODER.ATTN.LEARNABLE_PE = False
    _C.MODEL.POLICY.ACT_DECODER.ATTN.PE_NUM_FREQ = 64
    _C.MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER = 6
    _C.MODEL.POLICY.ACT_DECODER.ATTN.NUM_HEAD = 8
    _C.MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM = 16
    _C.MODEL.POLICY.ACT_DECODER.ATTN.DROPOUT = 0.1
    # fuse the a2p/m2p stack into one Pallas kernel on TPU (rollout path).
    # Measured on v5e at demo shapes the XLA path is currently faster
    # (17.6 vs 15.9 scenes/s end-to-end; the kernel's softmax layout is
    # lane-bound at H=8), so this defaults off.
    _C.MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK = False
    # single-pass Pallas edge-attention core (ops/edge_attn.py) inside each
    # attention layer whose shapes sit in its support window (K in [128,384],
    # D=128 -- the a2p stack at demo shapes); layers outside the window keep
    # the XLA path automatically. Defaults OFF: the isolated core wins at
    # K=160 (10.0 vs 12.4 ms/layer) but end-to-end the kernel call breaks
    # XLA's surrounding fusions and the full bench measures 19.6 vs 19.9
    # scenes/s, a net loss at demo shapes.
    _C.MODEL.POLICY.ACT_DECODER.ATTN.EDGE_KERNEL = False
    _C.MODEL.POLICY.ACT_DECODER.ATTN.AGENT_RADIUS = 100
    _C.MODEL.POLICY.ACT_DECODER.ATTN.MAP_RADIUS = 50
    _C.MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH = 768
    _C.MODEL.POLICY.ACT_DECODER.ATTN.NOT_USE_MAP = False

    _C.MODEL.CONDITION_TRANSFORMER = CN()
    _C.MODEL.CONDITION_TRANSFORMER.LR_SCALE = 10.0
    _C.MODEL.CONDITION_TRANSFORMER.USE_TEMPORAL_ENCODING = True
    _C.MODEL.CONDITION_TRANSFORMER.ATTN_TYPE = "gnn"
    _C.MODEL.CONDITION_TRANSFORMER.NLAYER = 3
    _C.MODEL.CONDITION_TRANSFORMER.NHEAD = 8
    _C.MODEL.CONDITION_TRANSFORMER.FF_DIM = 16
    _C.MODEL.CONDITION_TRANSFORMER.DROPOUT = 0.1
    _C.MODEL.CONDITION_TRANSFORMER.COND_POOL_FUNC = "mean"
    _C.MODEL.CONDITION_TRANSFORMER.USE_PLACEHOLDER = False
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_LOCATIONS = ["policy_decoder"]
    _C.MODEL.CONDITION_TRANSFORMER.PE = CN()
    _C.MODEL.CONDITION_TRANSFORMER.PE.ENABLE = False
    _C.MODEL.CONDITION_TRANSFORMER.PE.MAX_AGENT_NUM = 128
    _C.MODEL.CONDITION_TRANSFORMER.PE.SCALE = 1.0

    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER = CN()
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.DRAG_POINTS = CN()
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.DRAG_POINTS.NUM_PRE_LAYERS = 1
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.DRAG_POINTS.NUM_MLP_LAYERS = 3
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT = CN()
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.BASE_MODEL = "llama"
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM = CN()
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.USE_PROMPT_TOKEN = True
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.REPLACE_AGENT_TOKEN = True
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.MODEL = "llama3_8b_instruct"
    # 'auto' = llama3_8b when WEIGHTS_PATH is set else tiny; or explicit
    # 'tiny' / 'llama3_8b'
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.ARCH = "auto"
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.PROMPT_TAIL = True
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.AGENT_TOKEN_MODE = "none"
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.DETACH_PROMPT_TOKEN = False
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.LORA_LR_SCALE = 1.0
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.ADAPTER_LR_SCALE = 1.0
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.USE_TEXT_PROMPT_MASK = False
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.USE_SYSTEM_INSTRUCTION = False
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.ADD_BOS_EOS = False
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.WEIGHTS_PATH = ""
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.TOKENIZER_PATH = ""
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.MAX_TEXT_TOKENS = 256
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.TINY_FALLBACK = True
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.PROMPT_LOSS = CN()
    _C.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.PROMPT_LOSS.PROMPT_MASK_PRED = True

    _C.MODEL.CONDITION_TRANSFORMER.TEXT_ATTN = CN()
    _C.MODEL.CONDITION_TRANSFORMER.TEXT_ATTN.TYPE = "llama"
    _C.MODEL.CONDITION_TRANSFORMER.TEXT_ATTN.LORA = CN()
    _C.MODEL.CONDITION_TRANSFORMER.TEXT_ATTN.LORA.ENABLE = True
    _C.MODEL.CONDITION_TRANSFORMER.TEXT_ATTN.LORA.R = 16
    _C.MODEL.CONDITION_TRANSFORMER.TEXT_ATTN.LORA.DROPOUT = 0.1
    _C.MODEL.CONDITION_TRANSFORMER.TEXT_ATTN.LORA.ALPHA = 0.1
    _C.MODEL.CONDITION_TRANSFORMER.TEXT_ATTN.LORA.EMBEDDING_ONLY = False

    # --------------------------------------------------------------- parallel
    _C.PARALLEL = CN()
    _C.PARALLEL.DATA_AXIS = "data"
    _C.PARALLEL.MODEL_AXIS = "model"
    _C.PARALLEL.NUM_DATA = -1   # -1: all devices on the data axis
    _C.PARALLEL.NUM_MODEL = 1

    return _C


def fixup_derived_keys(config: CN) -> CN:
    """Apply derived-key fixups.

    Mirrors the reference's post-merge hook: when the policy predicts velocity
    the target state grows by (xd, yd) (reference: prosim/config/default.py:725-730),
    and DECODER gets its own copy of HIDDEN_DIM / REL_POS_EDGE_FUNC because the
    reference passes `config.MODEL` as the decoder root config.
    """
    frozen = config.is_frozen()
    config.defrost()
    if config.MODEL.POLICY.ACT_DECODER.TRAJ.PRED_VEL:
        elems = config.DATASET.FORMAT.TARGET.ELEMENTS.split(",")
        for e in ("xd", "yd"):
            if e not in elems:
                elems.append(e)
        config.DATASET.FORMAT.TARGET.ELEMENTS = ",".join(elems)
    config.MODEL.DECODER.HIDDEN_DIM = config.MODEL.HIDDEN_DIM
    config.MODEL.DECODER.REL_POS_EDGE_FUNC = config.MODEL.REL_POS_EDGE_FUNC
    if frozen:
        config.freeze()
    return config
