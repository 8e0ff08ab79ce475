"""TUM's translational relative pose error (``evaluate_rpe.py``) over
pairs one second of camera time apart, on the window's frames from
``System.frame_trajectory()`` against the ground truth (m)."""

from benchmark.reference import trajectory as T


def read(run):
    delta = int(round(run.fps_camera))
    if len(run.est_tcw_window) <= delta:
        return None
    return T.rpe_translation(T.tcw_to_twc(run.est_tcw_window),
                             run.gt_twc_window, delta)
