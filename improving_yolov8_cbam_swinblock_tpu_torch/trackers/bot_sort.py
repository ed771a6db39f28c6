"""BoT-SORT: BYTETracker with an XYWH Kalman state and camera-motion
compensation; the port's copy of the JAX package's trackers/bot_sort.py.

The ReID appearance hooks are there but off by default (botsort.yaml
with_reid: False). GMC (global motion compensation) runs sparseOptFlow on
cv2, imported only where it runs, or none. GMC runs only when update is
handed the frame, which YOLO.track does not do (as in the JAX package), so
tracking with BoT-SORT needs no cv2.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .byte_tracker import BYTETracker, STrack, TrackState, iou_distance, fuse_score, linear_assignment
from .kalman_filter import KalmanFilterXYWH


class GMC:
    """Global (camera) motion compensation by sparse optical flow: apply(frame)
    gives the (2, 3) affine map from the previous frame to this one
    (identity for method "none" and on the first frame)."""

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2):
        self.method = method
        self.downscale = max(1, int(downscale))
        self.prev_frame = None
        self.prev_pts = None
        self.initialized = False

    def apply(self, raw_frame: np.ndarray) -> np.ndarray:
        if self.method in ("none", "None", None):
            return np.eye(2, 3)
        import cv2

        frame = cv2.cvtColor(raw_frame, cv2.COLOR_BGR2GRAY)
        if self.downscale > 1:
            frame = cv2.resize(frame, (frame.shape[1] // self.downscale, frame.shape[0] // self.downscale))
        H = np.eye(2, 3)
        pts = cv2.goodFeaturesToTrack(
            frame, maxCorners=1000, qualityLevel=0.01, minDistance=1, blockSize=3,
            useHarrisDetector=False, k=0.04,
        )
        if not self.initialized or self.prev_pts is None:
            self.prev_frame = frame.copy()
            self.prev_pts = pts
            self.initialized = True
            return H
        if pts is None:
            return H
        nxt, status, _ = cv2.calcOpticalFlowPyrLK(self.prev_frame, frame, self.prev_pts, None)
        if nxt is None:
            self.prev_frame, self.prev_pts = frame.copy(), pts
            return H
        ok = status.flatten() == 1
        prev_ok, curr_ok = self.prev_pts[ok], nxt[ok]
        if len(prev_ok) > 4:
            M, inliers = cv2.estimateAffinePartial2D(prev_ok, curr_ok, method=cv2.RANSAC)
            if M is not None:
                H = M.copy()
                if self.downscale > 1:
                    H[0, 2] *= self.downscale
                    H[1, 2] *= self.downscale
        self.prev_frame, self.prev_pts = frame.copy(), pts
        return H


class BOTrack(STrack):
    shared_kalman = KalmanFilterXYWH()

    def __init__(self, xywh, score, cls, feat: Optional[np.ndarray] = None, feat_history: int = 50):
        super().__init__(xywh, score, cls)
        self.smooth_feat = None
        self.curr_feat = None
        if feat is not None:
            self.update_features(feat)
        self.alpha = 0.9

    def update_features(self, feat):
        feat = feat / (np.linalg.norm(feat) + 1e-12)
        self.curr_feat = feat
        self.smooth_feat = feat if self.smooth_feat is None else self.alpha * self.smooth_feat + (1 - self.alpha) * feat
        self.smooth_feat /= np.linalg.norm(self.smooth_feat) + 1e-12

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()  # xywh state
        ret[:2] -= ret[2:] / 2
        return ret

    @staticmethod
    def tlwh_to_xywh(tlwh):
        ret = np.asarray(tlwh, np.float32).copy()
        ret[:2] += ret[2:] / 2
        return ret

    def activate(self, kalman_filter, frame_id):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = kalman_filter.initiate(self.tlwh_to_xywh(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        if frame_id == 1:
            self.is_activated = True
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track, frame_id, new_id=False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xywh(new_track._tlwh)
        )
        if getattr(new_track, "curr_feat", None) is not None:
            self.update_features(new_track.curr_feat)
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score, self.cls, self.idx = new_track.score, new_track.cls, new_track.idx

    def update(self, new_track, frame_id):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xywh(new_track._tlwh)
        )
        if getattr(new_track, "curr_feat", None) is not None:
            self.update_features(new_track.curr_feat)
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score, self.cls, self.idx = new_track.score, new_track.cls, new_track.idx

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[6] = 0
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean_state, self.covariance)

    @staticmethod
    def multi_predict(stracks):
        if len(stracks) == 0:
            return
        means = np.array([st.mean.copy() for st in stracks])
        covs = np.array([st.covariance for st in stracks])
        for i, st in enumerate(stracks):
            if st.state != TrackState.Tracked:
                means[i][6] = 0
                means[i][7] = 0
        means, covs = BOTrack.shared_kalman.multi_predict(means, covs)
        for i, st in enumerate(stracks):
            st.mean, st.covariance = means[i], covs[i]

    @staticmethod
    def multi_gmc(stracks, H):
        """Move the tracks' states by the camera motion H (2, 3)."""
        if len(stracks) == 0:
            return
        R = H[:2, :2]
        t = H[:2, 2]
        for st in stracks:
            mean = st.mean.copy()
            mean[:2] = R @ mean[:2] + t
            mean[4:6] = R @ mean[4:6]
            st.mean = mean


class BOTSORT(BYTETracker):
    def __init__(self, proximity_thresh=0.5, appearance_thresh=0.25, gmc_method="sparseOptFlow", with_reid=False, **kw):
        super().__init__(**kw)
        self.proximity_thresh = proximity_thresh
        self.appearance_thresh = appearance_thresh
        self.with_reid = with_reid
        self.gmc = GMC(method=gmc_method)

    def get_kalmanfilter(self):
        return KalmanFilterXYWH()

    def init_track(self, xywhs, scores, clss, feats=None):
        tracks = []
        for i, (b, s, c) in enumerate(zip(xywhs, scores, clss)):
            t = BOTrack(b, s, c, feat=None if feats is None else feats[i])
            t.idx = i
            tracks.append(t)
        return tracks

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        dists_mask = dists > (1 - self.proximity_thresh)
        if self.fuse_score_flag:
            dists = fuse_score(dists, detections)
        if self.with_reid and tracks and detections:
            emb = np.array([
                [1 - float(np.dot(t.smooth_feat, d.curr_feat)) if t.smooth_feat is not None and d.curr_feat is not None else 1.0 for d in detections]
                for t in tracks
            ]) / 2.0
            emb[emb > self.appearance_thresh] = 1.0
            emb[dists_mask] = 1.0
            dists = np.minimum(dists, emb)
        else:
            dists[dists_mask] = 1.0
        return dists

    def update(self, boxes_xyxy, scores, clss, img: Optional[np.ndarray] = None):
        if img is not None:
            H = self.gmc.apply(img)
            BOTrack.multi_gmc(self.tracked_stracks, H)
            BOTrack.multi_gmc(self.lost_stracks, H)
        return super().update(boxes_xyxy, scores, clss)


def embedding_distance(tracks, detections, metric: str = "cosine") -> np.ndarray:
    """Appearance cost matrix over ReID features: rows are the tracks
    (smooth_feat if present, else feat), columns the detections (curr_feat,
    else feat); the cosine distance, clipped at 0."""
    cost = np.zeros((len(tracks), len(detections)), np.float32)
    if cost.size == 0:
        return cost
    det_f = np.asarray(
        [getattr(d, "curr_feat", None) if getattr(d, "curr_feat", None) is not None else d.feat for d in detections],
        np.float32,
    )
    trk_f = np.asarray(
        [getattr(t, "smooth_feat", None) if getattr(t, "smooth_feat", None) is not None else t.feat for t in tracks],
        np.float32,
    )
    trk_n = trk_f / (np.linalg.norm(trk_f, axis=1, keepdims=True) + 1e-12)
    det_n = det_f / (np.linalg.norm(det_f, axis=1, keepdims=True) + 1e-12)
    if metric != "cosine":
        raise ValueError(f"unsupported metric {metric!r}")
    return np.maximum(0.0, 1.0 - trk_n @ det_n.T)
