"""BYTETracker, the two-stage (high and low score) association tracker: the
port's copy of the JAX package's trackers/byte_tracker.py.

Per frame: Kalman predict of every track, IoU association of the
high-score detections (Hungarian matching, scipy's linear_sum_assignment),
a second pass of the low-score detections against the tracks left
unmatched, unconfirmed tracks against the rest, new tracks, and the
expiry of tracks lost for longer than track_buffer frames. A detection
without area takes no part (where the JAX package's tracker would fail on
it). Host numpy code, as in the JAX package; scipy is imported where it
matches, so the port imports without it.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .kalman_filter import KalmanFilterXYAH


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


def iou_distance(atracks: List, btracks: List) -> np.ndarray:
    """1 - IoU cost matrix between track boxes (xyxy)."""
    a = np.array([t.xyxy for t in atracks]).reshape(-1, 4)
    b = np.array([t.xyxy for t in btracks]).reshape(-1, 4)
    if len(a) == 0 or len(b) == 0:
        return np.ones((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), 2)
    a1 = np.prod(a[:, 2:] - a[:, :2], 1)
    a2 = np.prod(b[:, 2:] - b[:, :2], 1)
    return 1.0 - inter / (a1[:, None] + a2[None] - inter + 1e-7)


def fuse_score(cost_matrix: np.ndarray, detections: List) -> np.ndarray:
    """Blend the IoU similarity with the detections' scores."""
    if cost_matrix.size == 0:
        return cost_matrix
    iou_sim = 1 - cost_matrix
    det_scores = np.array([d.score for d in detections])
    fused = iou_sim * det_scores[None, :]
    return 1 - fused


def linear_assignment(cost_matrix: np.ndarray, thresh: float):
    """Hungarian matching, keeping the pairs whose cost is at most thresh:
    (matches (k, 2), unmatched rows, unmatched columns)."""
    if cost_matrix.size == 0:
        return (
            np.empty((0, 2), int),
            tuple(range(cost_matrix.shape[0])),
            tuple(range(cost_matrix.shape[1])),
        )
    import scipy.optimize

    row, col = scipy.optimize.linear_sum_assignment(cost_matrix)
    matches = [(r, c) for r, c in zip(row, col) if cost_matrix[r, c] <= thresh]
    ur = tuple(set(range(cost_matrix.shape[0])) - {m[0] for m in matches})
    uc = tuple(set(range(cost_matrix.shape[1])) - {m[1] for m in matches})
    return np.asarray(matches, int).reshape(-1, 2), ur, uc


class BaseTrack:
    """Track base: the id counter and the lifecycle state. The counter is a
    class attribute, shared by every tracker of the process; each new
    BYTETracker (and BOTSORT) resets it, so ids restart at 1 with a new
    tracker and continue with a kept one. STrack carries the Kalman
    geometry."""

    _count = 0

    track_id = 0
    state = TrackState.New
    is_activated = False
    score = 0.0
    start_frame = 0
    frame_id = 0

    @property
    def end_frame(self):
        return self.frame_id

    @staticmethod
    def next_id():
        BaseTrack._count += 1
        return BaseTrack._count

    @staticmethod
    def reset_id():
        BaseTrack._count = 0

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed


class STrack(BaseTrack):
    shared_kalman = KalmanFilterXYAH()

    def __init__(self, xywh, score, cls):
        self._tlwh = np.asarray(
            [xywh[0] - xywh[2] / 2, xywh[1] - xywh[3] / 2, xywh[2], xywh[3]], dtype=np.float32
        )
        self.kalman_filter = None
        self.mean, self.covariance = None, None
        self.is_activated = False
        self.score = float(score)
        self.cls = int(cls)
        self.track_id = 0
        self.state = TrackState.New
        self.frame_id = 0
        self.start_frame = 0
        self.tracklet_len = 0
        self.idx = -1

    # -- geometry -------------------------------------------------------
    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()  # xyah
        ret[2] *= ret[3]
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def xyxy(self):
        ret = self.tlwh
        return np.array([ret[0], ret[1], ret[0] + ret[2], ret[1] + ret[3]], np.float32)

    @property
    def xywh(self):
        ret = self.tlwh
        return np.array([ret[0] + ret[2] / 2, ret[1] + ret[3] / 2, ret[2], ret[3]], np.float32)

    @staticmethod
    def tlwh_to_xyah(tlwh):
        ret = np.asarray(tlwh, np.float32).copy()
        ret[:2] += ret[2:] / 2
        ret[2] /= ret[3]
        return ret

    # -- lifecycle ------------------------------------------------------
    def activate(self, kalman_filter, frame_id):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = kalman_filter.initiate(self.tlwh_to_xyah(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        if frame_id == 1:
            self.is_activated = True
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track, frame_id, new_id=False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xyah(new_track._tlwh)
        )
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def update(self, new_track, frame_id):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xyah(new_track._tlwh)
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
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
                means[i][7] = 0
        means, covs = STrack.shared_kalman.multi_predict(means, covs)
        for i, st in enumerate(stracks):
            st.mean, st.covariance = means[i], covs[i]

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed

    @property
    def end_frame(self):
        return self.frame_id

    @property
    def result(self):
        """[x1, y1, x2, y2, track_id, score, cls, det_idx]."""
        return np.r_[self.xyxy, self.track_id, self.score, self.cls, self.idx].astype(np.float32)


class BYTETracker:
    """Two-stage tracker: high-score detections are matched first; low-score
    detections rescue the tracks left unmatched."""

    def __init__(self, track_high_thresh=0.25, track_low_thresh=0.1, new_track_thresh=0.25, track_buffer=30, match_thresh=0.8, fuse_score_flag=True, frame_rate=30):
        self.tracked_stracks: List[STrack] = []
        self.lost_stracks: List[STrack] = []
        self.removed_stracks: List[STrack] = []
        self.frame_id = 0
        self.track_high_thresh = track_high_thresh
        self.track_low_thresh = track_low_thresh
        self.new_track_thresh = new_track_thresh
        self.match_thresh = match_thresh
        self.fuse_score_flag = fuse_score_flag
        self.max_time_lost = int(frame_rate / 30.0 * track_buffer)
        self.kalman_filter = self.get_kalmanfilter()
        self.reset_id()

    def get_kalmanfilter(self):
        return KalmanFilterXYAH()

    @staticmethod
    def reset_id():
        BaseTrack._count = 0

    def init_track(self, xywhs, scores, clss):
        tracks = []
        for i, (b, s, c) in enumerate(zip(xywhs, scores, clss)):
            t = STrack(b, s, c)
            t.idx = i
            tracks.append(t)
        return tracks

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        if self.fuse_score_flag:
            dists = fuse_score(dists, detections)
        return dists

    def update(self, boxes_xyxy: np.ndarray, scores: np.ndarray, clss: np.ndarray) -> np.ndarray:
        """Process one frame of detections; returns (n, 8) activated tracks."""
        self.frame_id += 1
        xywhs = np.stack(
            [
                (boxes_xyxy[:, 0] + boxes_xyxy[:, 2]) / 2,
                (boxes_xyxy[:, 1] + boxes_xyxy[:, 3]) / 2,
                boxes_xyxy[:, 2] - boxes_xyxy[:, 0],
                boxes_xyxy[:, 3] - boxes_xyxy[:, 1],
            ],
            axis=1,
        ) if len(boxes_xyxy) else np.zeros((0, 4), np.float32)

        # a box without area (clipped to the image's edge) never joins: its track would have an infinite aspect
        # ratio, whose NaN Kalman state fails the matching (the JAX package's tracker raises there)
        has_area = (xywhs[:, 2] > 0) & (xywhs[:, 3] > 0)
        remain = (scores >= self.track_high_thresh) & has_area
        low = (scores > self.track_low_thresh) & (scores < self.track_high_thresh) & has_area
        detections = self.init_track(xywhs[remain], scores[remain], clss[remain])
        detections_low = self.init_track(xywhs[low], scores[low], clss[low])
        idx_map = np.flatnonzero(remain)
        for t, i in zip(detections, idx_map):
            t.idx = int(i)
        idx_map_low = np.flatnonzero(low)
        for t, i in zip(detections_low, idx_map_low):
            t.idx = int(i)

        activated, refind, lost, removed = [], [], [], []
        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]
        strack_pool = joint_stracks(tracked, self.lost_stracks)
        STrack.multi_predict(strack_pool)

        # stage 1: high-score
        dists = self.get_dists(strack_pool, detections)
        matches, u_track, u_det = linear_assignment(dists, self.match_thresh)
        for it, idet in matches:
            track, det = strack_pool[it], detections[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)

        # stage 2: low-score rescue
        r_tracked = [strack_pool[i] for i in u_track if strack_pool[i].state == TrackState.Tracked]
        dists = iou_distance(r_tracked, detections_low)
        matches, u_track2, _ = linear_assignment(dists, 0.5)
        for it, idet in matches:
            track, det = r_tracked[it], detections_low[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)
        for i in u_track2:
            track = r_tracked[i]
            if track.state != TrackState.Lost:
                track.mark_lost()
                lost.append(track)

        # unconfirmed tracks vs remaining high-score dets
        dets_left = [detections[i] for i in u_det]
        dists = self.get_dists(unconfirmed, dets_left)
        matches, u_unconfirmed, u_det2 = linear_assignment(dists, 0.7)
        for it, idet in matches:
            unconfirmed[it].update(dets_left[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for i in u_unconfirmed:
            track = unconfirmed[i]
            track.mark_removed()
            removed.append(track)

        # new tracks
        for i in u_det2:
            track = dets_left[i]
            if track.score >= self.new_track_thresh:
                track.activate(self.kalman_filter, self.frame_id)
                activated.append(track)

        # expire old lost tracks
        for track in self.lost_stracks:
            if self.frame_id - track.end_frame > self.max_time_lost:
                track.mark_removed()
                removed.append(track)

        self.tracked_stracks = [t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = sub_stracks(self.lost_stracks, removed)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(self.tracked_stracks, self.lost_stracks)
        self.removed_stracks.extend(removed)
        if len(self.removed_stracks) > 1000:
            self.removed_stracks = self.removed_stracks[-999:]

        out = [t.result for t in self.tracked_stracks if t.is_activated]
        return np.stack(out) if out else np.zeros((0, 8), np.float32)


def joint_stracks(a: List[STrack], b: List[STrack]) -> List[STrack]:
    seen = {t.track_id for t in a}
    return a + [t for t in b if t.track_id not in seen]


def sub_stracks(a: List[STrack], b: List[STrack]) -> List[STrack]:
    ids = {t.track_id for t in b}
    return [t for t in a if t.track_id not in ids]


def remove_duplicate_stracks(sa, sb):
    pdist = iou_distance(sa, sb)
    pairs = np.where(pdist < 0.15)
    dupa, dupb = [], []
    for p, q in zip(*pairs):
        timep = sa[p].frame_id - sa[p].start_frame
        timeq = sb[q].frame_id - sb[q].start_frame
        if timep > timeq:
            dupb.append(q)
        else:
            dupa.append(p)
    resa = [t for i, t in enumerate(sa) if i not in dupa]
    resb = [t for i, t in enumerate(sb) if i not in dupb]
    return resa, resb
